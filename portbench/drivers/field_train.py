"""Steady-state TensoRF training at the field's final grid: the steps after
the last upsample, as ``train/trainer.py::train_field`` runs them.

Set-up draws the field (the configuration's ``init``), the alpha mask
(``make.cluster_volume`` at ``mask_grid``) and a pool of ``pool_frames``
frames' rays and RGBA targets on the card, and builds Adam at the
configuration's rates as ``train_field`` does after an upsample. A unit is
one step: ``batch_size`` ray indices from ``SimpleSampler``, one jitter draw
a ray (handed in, so that the reference sees the same samples),
``train_step`` with the L1 weight of the rest of the run; every
``progress_refresh_rate`` steps the loss is read on the host. The first
``compared`` steps are the ones the reference follows.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from portbench import counts as cnt
from portbench import make
from portbench.drivers import steps
from portbench.reference import field as ref
from portbench.reference import precision
from portbench.reference.optim import Adam

BETAS = (0.9, 0.99)
NETWORK = ("basis_mat", "shading")


class State:
    pass


def field_config(field: dict):
    from iffnerf_tpu_torch.models.field import FieldConfig

    keys = ("model_name", "app_dim", "shading_mode", "density_shift",
            "alpha_mask_thres", "distance_scale", "ray_march_weight_thres",
            "pos_pe", "view_pe", "fea_pe", "feature_c", "step_ratio",
            "fea2dense_act")
    return FieldConfig(
        aabb=tuple(tuple(a) for a in field["aabb"]),
        grid_size=tuple(field["grid_size"]),
        density_n_comp=tuple(field["density_n_comp"]),
        app_n_comp=tuple(field["app_n_comp"]),
        near_far=tuple(field["near_far"]), **{k: field[k] for k in keys})


def inputs(run):
    """(field parameters, mask volume, rays, rgbs) from the seed."""
    cfg, tr = run.config, run.traffic
    init = cfg["init"]
    params = make.field_params(run.seed, run.dev, cfg["field"],
                               density=tuple(init["density"]),
                               app=tuple(init["app"]))
    volume = make.cluster_volume(run.dev, cfg["mask_grid"])
    rays, rgbs = make.ray_pool(run.seed, run.dev, tr["pool_frames"],
                               *tr["frame_hw"], tr["camera_angle_x"],
                               tr["radius"])
    return params, volume, rays, rgbs


def lr_factor(train: dict) -> float:
    return train["lr_decay_target_ratio"] ** (1.0 / train["n_iters"])


def prepare(run):
    from iffnerf_tpu_torch.device import trainable
    from iffnerf_tpu_torch.models.field import make_alpha_mask
    from iffnerf_tpu_torch.train.trainer import SimpleSampler, make_optimizer

    cfg, tr, train = run.config, run.traffic, run.config["train"]
    st = State()
    st.run = run
    st.cfg = field_config(cfg["field"])
    params, st.volume, st.rays, st.rgbs = inputs(run)
    st.mask = make_alpha_mask(st.volume, cfg["field"]["aabb"])
    st.params = trainable(params, run.dev)
    del params
    st.opt = make_optimizer(st.params, train["lr_init"], train["lr_basis"],
                            lr_factor(train))
    st.sampler = SimpleSampler(st.rays.shape[0], train["batch_size"],
                               seed=run.seed)
    st.gen = make.generator(run.seed, run.dev, "draws")
    st.bg = torch.full((3,), 1.0 if train["white_bkgd"] else 0.0,
                       device=run.dev)
    st.weights = {"l1": train["L1_weight_rest"], "tv_d": 0.0, "tv_a": 0.0}
    st.n_samples = cnt.n_samples(cfg["field"])
    st.steps = st.failed = 0
    st.call_s = 0.0
    st.record = steps.Record(st.params)
    for i in range(tr["compared"]):
        idx, jitter, mse = _step(st)
        st.record.feeds.append((idx, jitter))
        st.record.losses.append(float(mse))
        if i == 0:
            st.record.grad1 = {k: v.clone() for k, v in steps.grad_from_adam(
                st.opt.adam, st.params, BETAS[0]).items()}
    st.record.after = {k: t.detach().clone()
                       for k, t in steps.named(st.params)}
    for _ in range(tr["warm_units"]):
        _step(st)
    st.steps = st.failed = 0
    st.call_s = 0.0
    return st


def _step(st):
    from iffnerf_tpu_torch.train.trainer import train_step

    idx = torch.as_tensor(st.sampler.nextids(), device=st.run.dev)
    jitter = torch.rand((idx.shape[0], 1), generator=st.gen,
                        device=st.run.dev)
    t = time.perf_counter()
    mse = train_step(st.cfg, st.params, st.opt, st.mask, st.rays[idx],
                     st.rgbs[idx], st.bg, st.weights, n_samples=st.n_samples,
                     jitter=jitter, use_l1=True)
    st.call_s += time.perf_counter() - t
    st.steps += 1
    if st.steps % st.run.config["train"]["progress_refresh_rate"] == 0:
        if not np.isfinite(float(mse)):
            st.failed += 1
    return idx, jitter, mse


def unit(st):
    _step(st)


def drain(st):
    if st.run.dev.type == "cuda":
        torch.cuda.synchronize(st.run.dev)


def tally(st):
    return st.steps, st.failed


@contextlib.contextmanager
def traced_hooks(st):
    yield


def host(st):
    return {"call_ms": st.call_s / max(st.steps, 1) * 1e3}


def counts(st):
    field = st.run.config["field"]
    b = st.run.config["train"]["batch_size"]
    samples = b * st.n_samples
    mask_cells = int(np.prod(st.run.config["mask_grid"]))
    return {"flops_per_unit": cnt.train_step_flops(field, b, st.n_samples),
            "field_least_s": cnt.field_least_s(field, samples, mask_cells)}


def marks(st):
    return {}


# --------------------------------------------------------------------------
# the reference
# --------------------------------------------------------------------------


def reference_steps(run, before: dict, volume, feeds, tf32: bool,
                    keep: int | None = None) -> steps.Record:
    """The reference's run of the compared steps from ``before`` on the
    batches ``feeds`` ([(rays, rgbs, jitter)]); ``keep`` rays of each batch
    alone where given (a fault)."""
    cfg, train = run.config, run.config["train"]
    field = cfg["field"]
    leaves = {k: v.clone().requires_grad_(True) for k, v in before.items()}
    params = steps.unflatten(leaves)
    order = list(leaves)
    lrs = [train["lr_basis"] if k.split("/")[0] in NETWORK
           else train["lr_init"] for k in order]
    adam = Adam([leaves[k] for k in order], lrs, BETAS)
    rec = steps.Record(params)
    rec.before = {k: v.detach().clone() for k, v in before.items()}
    n = cnt.n_samples(field)
    factor = lr_factor(train)
    with precision(tf32):
        for i, (rays, rgbs, jitter) in enumerate(feeds):
            mse = ref.loss_and_grads(
                field, params, volume, rays, rgbs, jitter, n,
                train["L1_weight_rest"], train["white_bkgd"],
                cfg["reference"]["chunk_rays"], keep)
            rec.losses.append(float(mse))
            if i == 0:
                rec.grad1 = {k: leaves[k].grad.detach().clone()
                             for k in order}
            adam.step(factor ** i)
    rec.after = {k: v.detach().clone() for k, v in leaves.items()}
    return rec


def check(run, st) -> dict:
    feeds = [(st.rays[idx], st.rgbs[idx], jitter)
             for idx, jitter in st.record.feeds]
    record, volume = st.record, st.volume
    for name in ("params", "opt", "rays", "rgbs", "mask", "sampler"):
        delattr(st, name)
    if run.dev.type == "cuda":
        torch.cuda.empty_cache()
    want = reference_steps(run, record.before, volume, feeds, tf32=False)
    return steps.gaps(record, want)


def control(run) -> dict:
    """Readings of the control (the reference in TF32 in the program's
    place) and of half the batch left out, at the cell's size."""
    from iffnerf_tpu_torch.train.trainer import SimpleSampler

    params, volume, rays, rgbs = inputs(run)
    before = {k: v for k, v in steps.named(params)}
    sampler = SimpleSampler(rays.shape[0], run.config["train"]["batch_size"],
                            seed=run.seed)
    gen = make.generator(run.seed, run.dev, "draws")
    feeds = []
    for _ in range(run.traffic["compared"]):
        idx = torch.as_tensor(sampler.nextids(), device=run.dev)
        jitter = torch.rand((idx.shape[0], 1), generator=gen, device=run.dev)
        feeds.append((rays[idx], rgbs[idx], jitter))
    del rays, rgbs
    want = reference_steps(run, before, volume, feeds, tf32=False)
    low = reference_steps(run, before, volume, feeds, tf32=True)
    half = reference_steps(run, before, volume, feeds, tf32=False,
                           keep=run.config["train"]["batch_size"] // 2)
    return {"control": steps.gaps(low, want), "half_batch": steps.gaps(half, want)}
