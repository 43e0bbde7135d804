"""TensoRF field training (reference train.py:126-504), the port of the JAX
package's ``train/trainer.py``.

A step renders a batch of rays with training jitter, adds the
regularisers to the photometric loss and takes one Adam step
(``train_step``). Between steps the host runs the phase events at their
iterations: the alpha-mask update (with the AABB shrink at the first and
the ray filtering at the second), and the log-spaced grid upsamples, each
of which rebuilds the optimizer on the new tensors as the JAX trainer does
(``train_field``). ``reconstruction`` loads the datasets and makes or
loads the field, then calls ``train_field``. Forward-facing scenes
(``--ndc_ray 1``) train on NDC rays, as the JAX trainer does: the samples
are linear in NDC depth with one jitter draw a sample, and the rays are
never filtered (not by the AABB before the first step, nor by the alpha
mask at the second mask update).

Optimizer parity (train.py:193-202,348-349): Adam with betas (0.9, 0.99)
and eps 1e-8, one group for the factor grids at ``lr_init`` and one for
``basis_mat`` and the shading head at ``lr_basis``; each rate is
``lr0 * lr_factor ** count`` with ``count`` the updates made so far, as
optax's ``exponential_decay(lr0, 1, lr_factor)`` gives it.

On CUDA a step runs the field's features and their gradient through
``field_features``' kernels and the alpha-mask lookup through the row
gather. The JAX package's TPU devices are not ported: the occupancy probe
and compaction ladder, the multi-step scan and the grouped bit-row mask
gate. Random draws (initialisation, jitter) come from
``torch.Generator``s; the batch sampler is numpy, as in the JAX package,
so one seed gives both the same ray indices.

The data mesh (``--data_mesh``, ``parallel.mesh``): every rank draws the
same batch indices and the whole batch's jitter from the same generator,
and takes its rows of both; parameters are replicated, and after each
backward the gradients are averaged over the ranks. Where the batch
divides by the mesh size each rank's loss is the JAX step's on its shard,
and the average of the replicated regularisers' gradients is theirs, so
the step is the unsharded one up to float summation order. Where it does
not, each rank's per-ray terms (the mse and the alpha term) are weighted
by ``size x rows / batch``, which keeps the step the unsharded one, as
the JAX package's GSPMD step (which pads the uneven split) is. After each
phase event rank 0's parameters, mask and Adam state are broadcast, as
the JAX trainer re-replicates its arrays; only rank 0 logs and writes
checkpoints.
"""

from __future__ import annotations

import json
import os
import sys
import time
import types

import numpy as np
import torch
import torch.distributed as dist

from iffnerf_tpu_torch.device import (
    as_tensor,
    leaves,
    resolve_device,
    trainable,
    tree_map,
)
from iffnerf_tpu_torch.models.field import (
    FieldConfig,
    density_l1,
    init_field,
    sample_alpha,
    shrink,
    tv_loss_app,
    tv_loss_density,
    update_alpha_mask,
    upsample_volume_grid,
    vector_comp_diffs,
)
from iffnerf_tpu_torch.parallel.mesh import (
    is_lead,
    lead_only,
    make_mesh,
    psum_flat,
    replicate,
    replicate_arrays,
    shard_bounds,
)
from iffnerf_tpu_torch.models.render import (
    filtering_rays_bbox,
    render_rays,
    sample_ray,
)
from iffnerf_tpu_torch.utils.misc import N_to_reso, cal_n_samples, n_voxel_schedule

NETWORK = ("basis_mat", "shading")  # the parameters at lr_basis


class _NullWriter:
    def add_scalar(self, *a, **k):
        pass

    def close(self):
        pass


def make_summary_writer(logfolder: str):
    """TensorBoard writer (reference train.py:157); a no-op writer when
    tensorboard does not import. The writer's files go through
    TensorBoard's own file layer (its ``notf`` route): otherwise it
    imports TensorFlow where that is installed, some seconds of every run's
    start, for local files it writes alike."""
    sys.modules.setdefault("tensorboard.compat.notf",
                           types.ModuleType("tensorboard.compat.notf"))
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(logfolder)
    except ImportError:
        return _NullWriter()


class SimpleSampler:
    """Random-permutation batch sampler with epoch reshuffle (reference
    train.py:23-35); numpy, so one seed gives the JAX package's indices."""

    def __init__(self, total: int, batch: int, seed: int = 20211202):
        self.total = total
        self.batch = batch
        self.curr = total
        self.ids = None
        self.rng = np.random.default_rng(seed)

    def nextids(self) -> np.ndarray:
        self.curr += self.batch
        if self.ids is None or self.curr + self.batch > self.total:
            self.ids = self.rng.permutation(self.total)
            self.curr = 0
        return self.ids[self.curr:self.curr + self.batch]


class FieldOptimizer:
    """Adam over a field's parameters in two groups, spatial (the factor
    grids) and network (``basis_mat``, ``shading``), each decaying as
    ``lr0 * lr_factor ** count`` (the JAX ``make_optimizer``)."""

    def __init__(self, params, lr_spatial: float, lr_network: float,
                 lr_factor: float):
        spatial = [t for k, v in params.items() if k not in NETWORK
                   for t in leaves(v)]
        network = [t for k in NETWORK if k in params for t in leaves(params[k])]
        self.base = (lr_spatial, lr_network)
        self.lr_factor = lr_factor
        self.count = 0
        self.adam = torch.optim.Adam(
            [{"params": spatial, "lr": lr_spatial},
             {"params": network, "lr": lr_network}],
            betas=(0.9, 0.99), eps=1e-8)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        for group, lr0 in zip(self.adam.param_groups, self.base):
            group["lr"] = lr0 * self.lr_factor ** self.count
        self.adam.step()
        self.count += 1


def make_optimizer(params, lr_spatial: float, lr_network: float,
                   lr_factor: float) -> FieldOptimizer:
    return FieldOptimizer(params, lr_spatial, lr_network, lr_factor)


def field_loss(config: FieldConfig, params, mask, rays, rgbs, bg_color,
               weights, *, n_samples: int, ortho_weight: float = 0.0,
               use_l1: bool = False, use_tv_density: bool = False,
               use_tv_app: bool = False, ndc_ray: bool = False, gen=None,
               jitter=None, ray_share: float = 1.0):
    """The training loss of a ray batch (the JAX step's ``loss_fn``,
    trainer.py:170-194) -> (total, mse). An RGBA target is blended with
    ``bg_color`` (reference train.py:277-281); ``weights`` holds the L1 and
    TV weights of this step; ``ndc_ray`` samples the rays in NDC; the
    jitter is ``jitter`` ([N, 1] on the AABB, [N, n_samples] in NDC) or
    drawn from ``gen``. ``ray_share`` weighs the per-ray terms in ``total``
    (the mse and the alpha term; a mesh's uneven shard, ``train_step``)."""
    rgb_map, _, _, alpha, _, _ = render_rays(
        config, params, mask, rays, gen=gen, jitter=jitter, is_train=True,
        bg_color=bg_color, ndc_ray=ndc_ray, n_samples=n_samples)
    if rgbs.shape[-1] > 3:
        rgbs = torch.clamp(rgbs[..., :3] * rgbs[..., -1:]
                           + bg_color * (1 - rgbs[..., -1:]), 0.0, 1.0)
    mse = torch.mean((rgb_map - rgbs) ** 2)
    total = mse if ray_share == 1.0 else ray_share * mse
    if ortho_weight > 0:
        total = total + ortho_weight * vector_comp_diffs(config, params)
    if use_l1:
        total = total + weights["l1"] * density_l1(config, params)
    if use_tv_density:
        total = total + weights["tv_d"] * tv_loss_density(config, params)
    if use_tv_app:
        total = total + weights["tv_a"] * tv_loss_app(config, params)
    # the exp(|alpha|) term of reference train.py:328-329
    alpha_term = 0.1 * torch.mean(torch.exp(torch.abs(alpha)))
    total = total + (alpha_term if ray_share == 1.0
                     else ray_share * alpha_term)
    return total, mse


def train_step(config: FieldConfig, params, opt: FieldOptimizer, mask, rays,
               rgbs, bg_color, weights, *, mark=None, mesh=None, **loss_kw):
    """One optimizer step on a ray batch -> its mse (a detached tensor).
    ``mark(label)``, when given, is called after the forward, the backward
    and the Adam update (for CUDA-event timing).

    With ``mesh`` the batch and its jitter (``jitter``, or the whole
    batch's draw from ``gen``) are the whole batch's: this rank takes its
    rows, and the gradients are averaged over the ranks after the
    backward; the mse returned is the whole batch's."""
    opt.zero_grad()
    if mesh is not None:
        rays, rgbs, loss_kw = _shard_batch(mesh, config, rays, rgbs, loss_kw)
    total, mse = field_loss(config, params, mask, rays, rgbs, bg_color,
                            weights, **loss_kw)
    if mark is not None:
        mark("forward")
    total.backward()
    if mesh is not None:
        mse = _average_gradients(mesh, params, mse, loss_kw["ray_share"])
    if mark is not None:
        mark("backward")
    opt.step()
    if mark is not None:
        mark("adam")
    return mse.detach()


def _shard_batch(mesh, config: FieldConfig, rays, rgbs, loss_kw):
    """This rank's rows of a whole batch and of its jitter, and the share
    of its per-ray terms (``size x rows / batch``: 1 where the batch
    divides)."""
    n = rays.shape[0]
    lo, hi = shard_bounds(mesh, n)
    loss_kw = dict(loss_kw)
    jitter, gen = loss_kw.pop("jitter", None), loss_kw.pop("gen", None)
    if jitter is None:
        # the draw sample_ray (one a ray) or sample_ray_ndc (one a sample)
        # makes from gen for the whole batch
        n_samples = loss_kw.get("n_samples", -1)
        width = ((n_samples if n_samples > 0 else config.n_samples)
                 if loss_kw.get("ndc_ray") else 1)
        jitter = torch.rand((n, width), generator=gen, device=gen.device)
    loss_kw["jitter"] = jitter[lo:hi]
    loss_kw["ray_share"] = (hi - lo) * mesh.size / n
    return rays[lo:hi], rgbs[lo:hi], loss_kw


def _average_gradients(mesh, params, mse, ray_share: float):
    """Averages the parameters' gradients over the mesh in one collective,
    with the whole batch's mse (each rank's weighted by its rows) riding
    along -> that mse."""
    ts = leaves(params)
    grads = [torch.zeros_like(t) if t.grad is None else t.grad for t in ts]
    *sums, mse_sum = psum_flat(grads + [(mse.detach() * ray_share)], mesh)
    for t, g in zip(ts, sums):
        t.grad = g / mesh.size
    return mse_sum / mesh.size


def data_mesh(args, log_fn=print):
    """The data mesh that ``--data_mesh`` asks for (the JAX package's
    flag): -1 on when the default process group (``runtime.setup``) has
    more than one rank, 0 off, 1 on (a one-process mesh without a group);
    -> the mesh or None."""
    flag = int(getattr(args, "data_mesh", -1))
    ranks = dist.get_world_size() if dist.is_initialized() else 1
    if flag == 0 or (flag < 0 and ranks < 2):
        return None
    mesh = make_mesh()
    log_fn(f"data mesh: {mesh.size} ranks on axis 'data'")
    return mesh


@torch.no_grad()
def filtering_rays_host(config: FieldConfig, all_rays, all_rgbs, mask=None,
                        n_samples: int = 256, chunk: int = 51200,
                        bbox_only: bool = False, device=None, log_fn=print):
    """Train-ray prefilter (reference filtering_rays, tensorBase.py:698-748):
    keep the rays that hit the AABB (``bbox_only``) or that touch an
    occupied alpha-mask voxel at one of ``n_samples`` unjittered samples.
    Runs in chunks on the rays' device (numpy rays on ``device``) ->
    (rays, rgbs), the kept rows as tensors on that device."""
    dev = (all_rays.device if isinstance(all_rays, torch.Tensor)
           else resolve_device(device))
    all_rays = as_tensor(all_rays, dev, torch.float32)
    all_rgbs = as_tensor(all_rgbs, dev, torch.float32)
    keep = []
    for i in range(0, all_rays.shape[0], chunk):
        rays = all_rays[i:i + chunk]
        if bbox_only:
            keep.append(filtering_rays_bbox(config, rays))
        else:
            xyz, _, _ = sample_ray(config, rays[:, :3], rays[:, 3:6],
                                   is_train=False, n_samples=n_samples)
            keep.append(torch.any(sample_alpha(mask, xyz) > 0, dim=-1))
    keep = torch.cat(keep) if keep else torch.zeros(0, dtype=torch.bool,
                                                    device=dev)
    log_fn(f"Ray filtering done! mask ratio: "
           f"{float(keep.sum()) / max(keep.numel(), 1):.4f}")
    return all_rays[keep], all_rgbs[keep]


def field_config_from_args(args, aabb, grid_size, near_far) -> FieldConfig:
    n_sigma = args.n_lamb_sigma or [16, 16, 16]
    n_sh = args.n_lamb_sh or [48, 48, 48]
    if len(n_sigma) == 1:
        n_sigma = n_sigma * 3
    if len(n_sh) == 1:
        n_sh = n_sh * 3
    return FieldConfig(
        model_name=args.model_name,
        aabb=tuple(map(tuple, np.asarray(aabb, dtype=np.float32).tolist())),
        grid_size=tuple(int(g) for g in grid_size),
        density_n_comp=tuple(n_sigma),
        app_n_comp=tuple(n_sh),
        app_dim=args.data_dim_color,
        shading_mode=args.shadingMode,
        near_far=tuple(float(x) for x in near_far),
        density_shift=args.density_shift,
        alpha_mask_thres=args.alpha_mask_thre,
        distance_scale=args.distance_scale,
        ray_march_weight_thres=args.rm_weight_mask_thre,
        pos_pe=args.pos_pe,
        view_pe=args.view_pe,
        fea_pe=args.fea_pe,
        feature_c=args.featureC,
        step_ratio=args.step_ratio,
        fea2dense_act=args.fea2denseAct,
        contraction_type=args.contraction_type,
    )


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_field(args, config: FieldConfig, params, mask, train_dataset,
                test_dataset, logfolder: str, seed: int = 20211202,
                log_fn=print, device=None, events: list | None = None,
                reso_cur=None, mesh=None):
    """The training loop of ``reconstruction`` (reference train.py:190-426)
    from a field ``(config, params, mask)`` -> (config, params, mask), the
    last saved to ``<logfolder>/<expname>.npz``.

    ``train_dataset`` holds flat ``all_rays`` [N, 6|7] and ``all_rgbs``
    [N, 3|4] (numpy, or tensors already on ``device``) and ``white_bg``;
    ``test_dataset`` is rendered every ``vis_every`` iterations when
    ``N_vis`` is not 0. ``args`` carries train.py's flags. With
    ``--resume_iter`` the run restarts at that iteration from a phase
    checkpoint given as the field. ``events``, a list, receives one dict a
    phase event (iteration, kind, host seconds up to a synchronize).
    ``reso_cur`` is the grid the sample count and the first mask update
    start from (``reconstruction`` passes ``--N_voxel_init``'s, as the JAX
    trainer does, also for a loaded field; the field's grid by default).
    ``mesh``, the data mesh, is ``data_mesh(args)`` unless given (module
    docstring); only its rank 0 logs and writes."""
    dev = resolve_device(device)
    if mesh is None:
        mesh = data_mesh(args, log_fn)
    lead = is_lead(mesh)
    log_fn = lead_only(mesh, log_fn)
    ndc_ray = bool(args.ndc_ray)
    white_bg = train_dataset.white_bg
    expname = args.expname or "exp"
    gen = torch.Generator(device=dev).manual_seed(seed)

    reso_cur = list(reso_cur or config.grid_size)
    n_samples = min(args.nSamples, cal_n_samples(reso_cur, args.step_ratio))
    lr_decay_iters = (args.lr_decay_iters if args.lr_decay_iters > 0
                      else args.n_iters)
    lr_factor = args.lr_decay_target_ratio ** (1.0 / lr_decay_iters)
    upsample_list = list(args.upsamp_list or [2000, 3000, 4000, 5500, 7000])
    update_mask_list = list(args.update_AlphaMask_list or [2000, 4000])
    n_voxel_list = n_voxel_schedule(args.N_voxel_init, args.N_voxel_final,
                                    len(upsample_list))

    if ndc_ray:
        allrays = as_tensor(train_dataset.all_rays, dev, torch.float32)
        allrgbs = as_tensor(train_dataset.all_rgbs, dev, torch.float32)
    else:
        allrays, allrgbs = filtering_rays_host(
            config, train_dataset.all_rays, train_dataset.all_rgbs,
            bbox_only=True, device=dev, log_fn=log_fn)
    batch_size = (args.train_batch_size if args.train_batch_size > 0
                  else args.batch_size)
    sampler = SimpleSampler(allrays.shape[0], batch_size, seed=seed)
    bg_color = torch.full((3,), 1.0 if white_bg else 0.0, device=dev)
    l1_weight = args.L1_weight_inital
    tv_d, tv_a = args.TV_weight_density, args.TV_weight_app
    loss_kw = dict(
        ortho_weight=args.Ortho_weight,
        use_l1=args.L1_weight_inital > 0 or args.L1_weight_rest > 0,
        use_tv_density=args.TV_weight_density > 0,
        use_tv_app=args.TV_weight_app > 0, ndc_ray=ndc_ray)

    # mid-schedule resume (trainer.py:559-594): restart at a phase boundary;
    # Adam's moments start fresh at the rate decayed since the last reset
    start_it = int(getattr(args, "resume_iter", 0) or 0)
    lr_decay0 = 1.0
    if start_it > 0:
        if args.ckpt is None:
            raise ValueError("--resume_iter requires --ckpt "
                             "(the auto-saved phase checkpoint)")
        for _ in range(sum(1 for u in upsample_list if u <= start_it)):
            if n_voxel_list:
                n_voxel_list.pop(0)
        if update_mask_list and start_it >= update_mask_list[0]:
            l1_weight = args.L1_weight_rest
        tv_d *= lr_factor ** start_it
        tv_a *= lr_factor ** start_it
        reso_cur = list(config.grid_size)
        n_samples = min(args.nSamples,
                        cal_n_samples(config.grid_size, args.step_ratio))
        if (mask is not None and not ndc_ray and len(update_mask_list) > 1
                and start_it >= update_mask_list[1]):
            allrays, allrgbs = filtering_rays_host(
                config, allrays, allrgbs, mask=mask, log_fn=log_fn)
            sampler = SimpleSampler(allrays.shape[0], batch_size,
                                    seed=seed + start_it)
        if args.lr_upsample_reset:
            last_reset = max([0] + [u for u in upsample_list if u <= start_it])
            lr_decay0 = lr_factor ** (start_it - last_reset)
        else:
            lr_decay0 = lr_factor ** start_it
        log_fn(f"resuming at it {start_it} (grid {config.grid_size}, "
               f"{n_samples} samples, lr decay {lr_decay0:.4f})")

    params = trainable(params, dev)
    opt = make_optimizer(params, args.lr_init * lr_decay0,
                         args.lr_basis * lr_decay0, lr_factor)
    ckpt_every = int(getattr(args, "ckpt_every", 0) or 0)

    def replicated():
        """Rank 0's parameters, mask and Adam state on every rank (after
        the phase events, as the JAX trainer re-replicates)."""
        if mesh is not None:
            replicate(mesh, params)
            replicate_arrays(mesh, mask)
            replicate_arrays(mesh, [opt.adam.state[t] for t in leaves(params)
                                    if t in opt.adam.state])

    replicated()

    def save_phase_ckpt(it_done: int):
        """Crash insurance at phase boundaries: restart with --ckpt
        <expname>_phase.npz --resume_iter <it of phase_ckpt.json>."""
        from iffnerf_tpu_torch.checkpoint import save_field

        if not lead:
            return

        save_field(f"{logfolder}/{expname}_phase.npz", config, params, mask)
        with open(f"{logfolder}/phase_ckpt.json", "w") as f:
            json.dump({"it": it_done, "compact_ratio": config.compact_ratio}, f)

    def event(it_done: int, kind: str, t0: float):
        if events is not None:
            _sync(dev)
            events.append({"it": it_done, "event": kind,
                           "s": time.perf_counter() - t0,
                           "grid": list(config.grid_size)})

    writer = make_summary_writer(logfolder) if lead else _NullWriter()
    psnrs, psnrs_test = [], [0.0]
    t_start = time.perf_counter()
    for it in range(start_it, args.n_iters):
        idx = torch.as_tensor(sampler.nextids(), device=dev)
        tv_d, tv_a = tv_d * lr_factor, tv_a * lr_factor
        weights = {"l1": l1_weight, "tv_d": tv_d, "tv_a": tv_a}
        mse = train_step(
            config, params, opt, mask, allrays[idx], allrgbs[idx], bg_color,
            weights, n_samples=n_samples, gen=gen, mesh=mesh, **loss_kw)

        if (it + 1) % args.progress_refresh_rate == 0:
            m = float(mse)
            psnr = -10.0 * np.log(m) / np.log(10.0)
            psnrs.append(psnr)
            writer.add_scalar("train/PSNR", psnr, global_step=it)
            writer.add_scalar("train/mse", m, global_step=it)
            log_fn(f"it {it + 1:05d} train_psnr {np.mean(psnrs):.2f} "
                   f"test_psnr {np.mean(psnrs_test):.2f} mse {m:.6f}")
            psnrs = []

        if args.N_vis != 0 and (it + 1) % args.vis_every == 0:
            from iffnerf_tpu_torch.render.renderer import evaluation

            psnrs_test = evaluation(
                test_dataset, config, params, mask, f"{logfolder}/imgs_vis",
                N_vis=args.N_vis, prtx=f"{it + 1:06d}_", n_samples=n_samples,
                white_bg=white_bg, ndc_ray=ndc_ray,
                compute_extra_metrics=False, mesh=mesh, device=dev)
            writer.add_scalar("test/psnr", float(np.mean(psnrs_test)),
                              global_step=it)

        if ckpt_every > 0 and (it + 1) % ckpt_every == 0 \
                and it + 1 < args.n_iters:
            save_phase_ckpt(it + 1)

        if it + 1 in update_mask_list:
            t0 = time.perf_counter()
            reso_mask = reso_cur
            if reso_cur[0] * reso_cur[1] * reso_cur[2] > 256 ** 3:
                reso_mask = [256, 256, 256]
            mask, new_aabb, _ = update_alpha_mask(config, params, mask,
                                                  tuple(reso_mask))
            if mesh is not None:  # before the shrink and the ray filter
                replicate_arrays(mesh, mask)
            kind = "alpha-mask update"
            if it + 1 == update_mask_list[0]:
                config, params = shrink(config, params, new_aabb,
                                        mask.volume.shape[::-1])
                params = trainable(params, dev)
                l1_weight = args.L1_weight_rest
                n_samples = min(args.nSamples,
                                cal_n_samples(config.grid_size,
                                              args.step_ratio))
                # shrink changes the grids' shapes: Adam is rebuilt on the
                # new tensors at the decayed rate (trainer.py:780-793)
                decay = lr_factor ** (it + 1)
                opt = make_optimizer(params, args.lr_init * decay,
                                     args.lr_basis * decay, lr_factor)
                kind += " + shrink"
            if (not ndc_ray and len(update_mask_list) > 1
                    and it + 1 == update_mask_list[1]):
                allrays, allrgbs = filtering_rays_host(
                    config, allrays, allrgbs, mask=mask, log_fn=log_fn)
                sampler = SimpleSampler(allrays.shape[0], batch_size,
                                        seed=seed + it)
                kind += " + ray filtering"
            replicated()
            save_phase_ckpt(it + 1)
            event(it + 1, kind, t0)

        if it + 1 in upsample_list:
            t0 = time.perf_counter()
            n_voxels = n_voxel_list.pop(0)
            reso_cur = N_to_reso(n_voxels, config.aabb_np)
            n_samples = min(args.nSamples,
                            cal_n_samples(reso_cur, args.step_ratio))
            with torch.no_grad():
                config, params = upsample_volume_grid(config, params, reso_cur)
            params = trainable(params, dev)
            lr_scale = (1.0 if args.lr_upsample_reset
                        else args.lr_decay_target_ratio ** (it / args.n_iters))
            opt = make_optimizer(params, args.lr_init * lr_scale,
                                 args.lr_basis * lr_scale, lr_factor)
            replicated()
            save_phase_ckpt(it + 1)
            event(it + 1, "upsample", t0)

    total_s = time.perf_counter() - t_start
    log_fn(f"total training time: {total_s:.1f}s "
           f"({1000 * total_s / max(args.n_iters - start_it, 1):.2f} ms/it)")
    writer.close()
    params = tree_map(lambda t: t.detach(), params)
    from iffnerf_tpu_torch.checkpoint import save_field

    if lead:
        save_field(f"{logfolder}/{expname}.npz", config, params, mask)
    return config, params, mask


def reconstruction(args, seed: int = 20211202, log_fn=print, device=None):
    """Full training run (reference reconstruction, train.py:126-504) on
    ``device`` (CUDA unless ``device="cpu"``): loads the datasets, makes
    the field (or loads ``--ckpt``), trains it with ``train_field`` and runs
    the final renders that the flags ask for. -> (config, params, mask,
    logfolder)."""
    from iffnerf_tpu_torch.checkpoint import load_field
    from iffnerf_tpu_torch.data import dataset_dict

    dev = resolve_device(device)
    loader = dataset_dict[args.dataset_name]
    train_dataset = loader(args.datadir, split="train",
                           downsample=args.downsample_train, is_stack=False)
    test_dataset = loader(args.datadir, split="test",
                          downsample=args.downsample_train, is_stack=True)
    logfolder = os.path.join(args.basedir, args.expname or "exp")
    if getattr(args, "add_timestamp", 0):
        import datetime

        logfolder += datetime.datetime.now().strftime("-%Y%m%d-%H%M%S")
    os.makedirs(f"{logfolder}/imgs_vis", exist_ok=True)

    aabb = train_dataset.scene_bbox
    reso_cur = N_to_reso(args.N_voxel_init, aabb)
    mask = None
    if args.ckpt is not None:
        config, params, mask = load_field(args.ckpt, device=dev)
    else:
        config = field_config_from_args(args, aabb, reso_cur,
                                        train_dataset.near_far)
        params = init_field(torch.Generator(device=dev).manual_seed(seed),
                            config)
    mesh = data_mesh(args, log_fn)
    config, params, mask = train_field(
        args, config, params, mask, train_dataset, test_dataset, logfolder,
        seed=seed, log_fn=log_fn, device=dev, reso_cur=reso_cur, mesh=mesh)
    n_samples = min(args.nSamples,
                    cal_n_samples(config.grid_size, args.step_ratio))
    final_renders(args, config, params, mask, logfolder, test_dataset,
                  n_samples, log_fn=log_fn, device=dev, mesh=mesh)
    return config, params, mask, logfolder


def final_renders(args, config, params, mask, logfolder, test_dataset,
                  n_samples: int = -1, log_fn=print, device=None, mesh=None):
    """The train and test renders that ``--render_train`` and
    ``--render_test`` ask for, and the camera path's video that
    ``--render_path`` asks for where the dataset has a path (reference
    train.py:431-497) -> {split: mean PSNR}. With ``mesh`` the renders'
    rays are split over its ranks, and only its rank 0 logs and writes."""
    from iffnerf_tpu_torch.data import dataset_dict
    from iffnerf_tpu_torch.render.renderer import evaluation, evaluation_path

    log_fn = lead_only(mesh, log_fn)

    ndc_ray = bool(args.ndc_ray)
    white_bg = test_dataset.white_bg
    out = {}
    splits = []
    if args.render_train:
        splits.append(("train", dataset_dict[args.dataset_name](
            args.datadir, split="train", downsample=args.downsample_train,
            is_stack=True)))
    if args.render_test:
        splits.append(("test", test_dataset))
    for name, ds in splits:
        psnrs = evaluation(ds, config, params, mask,
                           f"{logfolder}/imgs_{name}_all", N_vis=-1,
                           n_samples=n_samples, white_bg=white_bg,
                           ndc_ray=ndc_ray, mesh=mesh, device=device)
        out[name] = float(np.mean(psnrs))
        log_fn(f"======> {args.expname} {name} all psnr: {out[name]} <====")
    if args.render_path and test_dataset.render_path is not None:
        evaluation_path(config, params, mask, test_dataset.render_path,
                        test_dataset, f"{logfolder}/imgs_path_all",
                        n_samples=n_samples, white_bg=white_bg,
                        ndc_ray=ndc_ray, mesh=mesh, device=device)
    return out
