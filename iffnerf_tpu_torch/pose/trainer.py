"""ID-module trainer (reference pose_estimation/train.py:8-234), the port of
the JAX package's ``pose/trainer.py``.

1500 iterations by default; an optimizer step accumulates the gradients of
32 random train images, drops those of a non-finite loss and applies Adam
with one rate for the ray side and the attention (4e-3) and another for the
backbone (1e-3). The candidate rays are renewed every 10 iterations.
Training is float32 (``IDConfig``'s default ``compute_dtype``) with TF32
off (``device.py``), and scores with the exact torch path: it never calls
the banked or fused scoring kernels, whose wrappers refuse autograd.

The candidate-ray features do not depend on the image, so a step computes
them once, runs every image's loss against a detached copy that collects
their cotangents, and sends the summed cotangent back through the ray MLP
once: the JAX step's explicit VJP, and mathematically the reference's 32
independent backward passes. The JAX package's scan of several steps in
one dispatch (``make_id_train_scan``) is a TPU dispatch device; here a
step is one call.

Under a data mesh (``parallel.mesh``; the JAX package shards the
candidate-ray axis of ``make_id_train_step`` and lets GSPMD make the
softmax's reductions collectives, ``tests/test_parallel.py``) every rank
gets the whole ray set and takes its rows (``shard_bounds``). An image's
softmax over rays is the whole set's (``id_module.softmax_over_rays``:
the maximum through ``pmax``, no gradient, the denominator through the
differentiable ``psum``); the target's normalisation is a ``psum`` of its
sums; the mse is the rank's sum of squares over the whole ray count
(``distance_based_score_loss``). Each rank differentiates its own
part of the loss, so its gradients are parts of the whole set's, and one
flat all-reduce sums them before Adam. The finite-loss skip reads the
whole loss, so every rank drops the same images.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from iffnerf_tpu_torch.device import (
    as_tensor,
    leaves,
    resolve_device,
    trainable,
    tree_map,
)
from iffnerf_tpu_torch.nn import linear_apply
from iffnerf_tpu_torch.parallel.mesh import (
    is_lead,
    lead_only,
    psum,
    psum_flat,
    replicate,
    shard_bounds,
)
from iffnerf_tpu_torch.pose.id_module import (
    IDConfig,
    distance_based_score_loss,
    image_queries,
    ray_features,
    softmax_over_rays,
)
from iffnerf_tpu_torch.train.trainer import _NullWriter, make_summary_writer

LEARNING_RATES = {"ray_mlp": 4.0e-3, "ray_mlp2": 4.0e-3, "q_proj": 4.0e-3,
                  "k_proj": 4.0e-3, "backbone": 1.0e-3}
# the parameters each image's loss reaches; the ray MLP's are reached
# through the ray features alone
IMAGE_SIDE = ("backbone", "q_proj", "k_proj")


def make_id_optimizer(params) -> torch.optim.Adam:
    """Adam over ``params``' leaves, one group a rate, keyed by top-level
    key (JAX ``make_id_optimizer``, optax's defaults: betas (0.9, 0.999),
    eps 1e-8 added after the square root)."""
    groups = {}
    for key, sub in params.items():
        groups.setdefault(LEARNING_RATES[key], []).extend(leaves(sub))
    return torch.optim.Adam(
        [{"params": ps, "lr": lr} for lr, ps in groups.items()],
        betas=(0.9, 0.999), eps=1e-8)


def per_image_loss(params, config: IDConfig, feats_rays, img, mask, pose,
                   rays_ori, rays_dirs, axis_name=None, n_rays=None):
    """One image's distance-based score loss against the ray features: the
    k projection, float32 logits, a softmax over the ray axis and the
    validity-weighted column sums (JAX ``_make_id_step_core``'s
    ``per_image_loss``), the softmax differentiated as ``jax.nn.softmax``
    is (``softmax_over_rays``).

    With ``axis_name`` the rays are this rank's rows of ``n_rays`` (a mesh
    axis, ``parallel.mesh``): the softmax and the target's sum run over the
    whole set, and the loss returned is this rank's part of the whole
    set's mse (their sum over the ranks)."""
    q, patch_valid, _ = image_queries(params, config, img, mask)
    dt = config.dtype
    k = linear_apply({n: v.to(dt) for n, v in params["k_proj"].items()},
                     feats_rays.to(dt))
    logits = (q.float() @ k.float().T) / math.sqrt(q.shape[-1])
    attention = softmax_over_rays(logits, axis_name)
    scores = torch.where(patch_valid[:, None], attention, 0.0).sum(dim=0)
    loss, _ = distance_based_score_loss(scores, pose, rays_ori, rays_dirs,
                                        patch_valid.sum(), axis_name, n_rays)
    return loss


def id_train_step(params, opt: torch.optim.Optimizer, imgs, masks, poses,
                  rays_ori, rays_dirs, rays_rgb, config: IDConfig,
                  accum_steps: int, mark=None, mesh=None) -> torch.Tensor:
    """One optimizer step over the images of ``imgs`` [N, H, W, 3] (white-
    blended), ``masks`` [N, H, W] and ``poses`` [N, 4, 4]; the rays are the
    current candidate set, its directions as the trainer passes them
    (negated). ``params``' leaves are the tensors ``opt`` steps. Returns
    the mean loss as a device scalar, with no host sync.

    An image whose loss is not finite adds nothing, and the sum is still
    divided by ``accum_steps`` (JAX: ``jnp.where`` on the loss's finiteness;
    a device-side select here too, where a host ``if`` would sync once an
    image). ``mark(label)``, when given, is called after each part of the
    step (ray features, image losses, ray backward, Adam), e.g. to record
    CUDA events.

    With ``mesh`` the rays are the whole set, alike on every rank; this
    rank takes its rows, the softmax's reductions run over the mesh
    (``per_image_loss``) and the ranks' gradients are summed before Adam
    (the module's docstring). Every rank returns the whole loss."""
    tick = mark or (lambda label: None)
    opt.zero_grad(set_to_none=True)
    n_rays = rays_ori.shape[0]
    if mesh is not None:
        lo, hi = shard_bounds(mesh, n_rays)
        rays_ori, rays_dirs, rays_rgb = (a[lo:hi] for a in
                                         (rays_ori, rays_dirs, rays_rgb))
    feats = ray_features(params, config, rays_ori, rays_dirs, rays_rgb)
    feats_in = feats.detach().requires_grad_(True)
    tick("ray_features")
    # the per-image loss never reaches ray_mlp or ray_mlp2, whose leaves
    # autograd.grad would refuse as unused: ask for the image side alone
    image_leaves = [t for key in IMAGE_SIDE for t in leaves(params[key])]
    grads = [torch.zeros_like(t) for t in image_leaves]
    dfeats = torch.zeros_like(feats_in)
    loss_sum = torch.zeros((), device=feats.device)
    for i in range(imgs.shape[0]):
        loss = per_image_loss(params, config, feats_in, imgs[i], masks[i],
                              poses[i], rays_ori, rays_dirs, axis_name=mesh,
                              n_rays=n_rays)
        *g_params, g_feats = torch.autograd.grad(loss,
                                                 image_leaves + [feats_in])
        whole = loss.detach() if mesh is None else psum(loss.detach(), mesh)
        ok = torch.isfinite(whole)
        for acc, g in zip(grads, g_params):
            acc.add_(torch.where(ok, g, 0.0))
        dfeats.add_(torch.where(ok, g_feats, 0.0))
        loss_sum = loss_sum + torch.where(ok, whole, 0.0)
    tick("image_losses")
    feats.backward(dfeats)
    tick("ray_backward")
    for t, g in zip(image_leaves, grads):
        t.grad = g
    ts = [t for group in opt.param_groups for t in group["params"]]
    with torch.no_grad():
        if mesh is not None:
            for t, g in zip(ts, psum_flat([t.grad for t in ts], mesh)):
                t.grad = g
        for t in ts:
            t.grad.div_(accum_steps)
    opt.step()
    tick("adam")
    return loss_sum / accum_steps


def blend_batch(batch: torch.Tensor):
    """RGBA over white, masks alpha > 0.3; RGB passes with an all-true
    mask (JAX ``train_id_module``, :264-270)."""
    if batch.shape[-1] == 4:
        alpha = batch[..., -1:]
        return batch[..., :3] * alpha + (1 - alpha), batch[..., -1] > 0.3
    return batch, torch.ones(batch.shape[:-1], dtype=torch.bool,
                             device=batch.device)


def train_id_module(id_params, id_config: IDConfig, rays_generator,
                    train_dataset, val_dataset, sequence_id: str = "",
                    n_iterations: int = 1500,
                    gradient_accumulation_steps: int = 32,
                    renewal_every_n_iterations: int = 10,
                    val_every_n_iterations: int = 20,
                    start_iterations: int = 0, log_fn=print, eval_fn=None,
                    rng: np.random.Generator | None = None, device=None,
                    mesh=None):
    """Trains copies of ``id_params`` on ``device`` (CUDA unless
    ``device="cpu"``) -> (trained params, model_up [3]).

    ``rays_generator()`` yields a candidate set (rays_ori, rays_dirs,
    rays_rgb), called at the first iteration and every
    ``renewal_every_n_iterations``; ``eval_fn(params, rays, model_up)``, if
    given, runs under ``torch.no_grad`` every ``val_every_n_iterations``.
    The image-index rows come from ``rng`` (``np.random.default_rng(0)``
    when None), one row of ``gradient_accumulation_steps`` a step, so a
    caller can feed the stream of the JAX function. ``start_iterations``
    resumes a run (the optimizer's moments start afresh, as in the JAX
    package). The pool of train images moves to ``device`` once, and each
    step's batch is gathered and blended there. ``val_dataset`` and
    ``sequence_id`` are taken, unused, as the JAX function takes them.

    With ``mesh`` each step's candidate rays are split over its ranks
    (``id_train_step``): each renewal's set is rank 0's, broadcast, and
    ``rng`` must give every rank the same rows (the same seed); only rank
    0 logs and writes TensorBoard scalars."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0) if rng is None else rng
    params = trainable(id_params, dev)
    opt = make_id_optimizer(params)
    log_fn = lead_only(mesh, log_fn)
    writer = make_summary_writer("runs") if is_lead(mesh) else _NullWriter()

    w, h = train_dataset.img_wh
    n_pool = len(train_dataset.all_rgbs)
    pool = as_tensor(train_dataset.all_rgbs, dev, torch.float32).reshape(
        n_pool, h, w, -1)
    poses_np = np.asarray(train_dataset.poses, np.float32)
    poses = as_tensor(poses_np, dev)
    # model_up = mean of train-pose Y columns (pose_estimation/train.py:60)
    model_up = as_tensor(poses_np[:, :3, 1].mean(axis=0), dev)

    rays = None
    running = 0.0
    for it in range(start_iterations, n_iterations):
        if rays is None or it % renewal_every_n_iterations == 0:
            rays = tuple(as_tensor(a, dev, torch.float32)
                         for a in rays_generator())
            if mesh is not None:
                replicate(mesh, rays)
        row = torch.as_tensor(
            rng.integers(0, n_pool, gradient_accumulation_steps), device=dev)
        imgs, masks = blend_batch(pool[row])
        # training scores the NEGATED directions (pose_estimation/train.py:
        # 98, JAX trainer.py:260,273); the test pass takes them as they are
        loss = float(id_train_step(
            params, opt, imgs, masks, poses[row], rays[0], -rays[1], rays[2],
            id_config, gradient_accumulation_steps, mesh=mesh))
        running += loss
        writer.add_scalar("train/loss", loss, global_step=it)
        if (it + 1) % 20 == 0:
            log_fn(f"[{it}] loss: {running / 20}")
            running = 0.0
        if eval_fn is not None and (it + 1) % val_every_n_iterations == 0:
            with torch.no_grad():
                eval_fn(params, rays, model_up)

    writer.close()
    return tree_map(lambda t: t.detach(), params), model_up
