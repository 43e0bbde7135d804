"""ID-module training at full width, as ``pose/trainer.py::train_id_module``
runs it between candidate-set renewals.

Set-up draws the ID module's weights, a pool of ``pool_frames`` RGBA frames
with their cameras and a fixed candidate set shaped as ``explore_field``'s
(renewals are not in the window), and builds Adam as ``train_id_module``
does. A unit is one optimizer step: ``accum`` rows of the pool drawn from
the seed, blended over white (``blend_batch``), ``id_train_step`` on the
negated directions, the loss read on the host. The first ``compared`` steps
are the ones the reference follows.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from portbench import counts as cnt
from portbench import make
from portbench.drivers import steps
from portbench.drivers.pose_sweep import id_config
from portbench.reference import pose as ref
from portbench.reference import precision
from portbench.reference.optim import Adam

BETAS = (0.9, 0.999)


class State:
    pass


def inputs(run):
    """(ID weights, pool RGBA, pool c2w, candidate rays) from the seed."""
    pose, tr = run.config["pose"], run.traffic
    params = make.id_params(run.seed, run.dev, pose)
    rgba, c2w = make.id_pool(run.seed, run.dev, tr["pool_frames"],
                             *tr["frame_hw"], tr["radius"])
    rays = make.candidate_rays(run.seed, run.dev, pose["gen_points"],
                               pose["isocell_dirs"])
    return params, rgba, c2w, rays


def prepare(run):
    from iffnerf_tpu_torch.device import trainable
    from iffnerf_tpu_torch.pose.trainer import make_id_optimizer

    pose, tr = run.config["pose"], run.traffic
    st = State()
    st.run = run
    st.cfg = id_config(pose, "float32", fused_bank=False)
    params, st.pool, st.poses, st.rays = inputs(run)
    st.params = trainable(params, run.dev)
    del params
    st.opt = make_id_optimizer(st.params)
    st.rng = np.random.default_rng(run.seed)
    st.accum = pose["id_accum"]
    st.mark = None
    st.events = []
    st.steps = st.failed = 0
    st.call_s = 0.0
    st.record = steps.Record(st.params)
    for i in range(tr["compared"]):
        row, loss = _step(st)
        st.record.feeds.append(row)
        st.record.losses.append(float(loss))
        if i == 0:
            st.record.grad1 = {k: v.clone() for k, v in steps.grad_from_adam(
                st.opt, st.params, BETAS[0]).items()}
    st.record.after = {k: t.detach().clone()
                       for k, t in steps.named(st.params)}
    for _ in range(tr["warm_units"]):
        _step(st)
    st.steps = st.failed = 0
    st.call_s = 0.0
    if run.trace and run.dev.type == "cuda":
        # CUDA events at the step's marks (id_train_step's mark) through
        # the traced run's window
        st.mark = lambda label: _mark(st, label)
    return st


def _step(st):
    from iffnerf_tpu_torch.pose.trainer import blend_batch, id_train_step

    row = torch.as_tensor(st.rng.integers(0, st.pool.shape[0], st.accum),
                          device=st.run.dev)
    if st.mark is not None:
        st.mark("start")
    imgs, masks = blend_batch(st.pool[row])
    ori, dirs, rgb = st.rays
    t = time.perf_counter()
    loss = id_train_step(st.params, st.opt, imgs, masks, st.poses[row], ori,
                         -dirs, rgb, st.cfg, st.accum, mark=st.mark)
    st.call_s += time.perf_counter() - t
    st.steps += 1
    if not np.isfinite(float(loss)):
        st.failed += 1
    return row, loss


def unit(st):
    _step(st)


def drain(st):
    if st.run.dev.type == "cuda":
        torch.cuda.synchronize(st.run.dev)


def tally(st):
    return st.steps, st.failed


@contextlib.contextmanager
def traced_hooks(st):
    """No marks in the traced segment: the profiler slows the host, and
    the marks read the window's steps."""
    st.mark = None
    yield


def _mark(st, label):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    st.events.append((label, ev))


def host(st):
    return {"call_ms": st.call_s / max(st.steps, 1) * 1e3}


def counts(st):
    pose = st.run.config["pose"]
    rays = pose["gen_points"] * pose["isocell_dirs"]
    return {"flops_per_unit": cnt.id_step_flops(pose, rays, st.accum)}


def marks(st):
    """Device ms a step between the marks of the traced run's window, by
    the label that closes each span."""
    if not st.events:
        return {}
    torch.cuda.synchronize()
    out, n = {}, 0
    for (_, a), (label, b) in zip(st.events, st.events[1:]):
        if label == "start":
            n += 1
            continue
        out[label] = out.get(label, 0.0) + a.elapsed_time(b)
    n = max(n + 1, 1)
    return {f"{k}_ms": v / n for k, v in out.items()}


# --------------------------------------------------------------------------
# the reference
# --------------------------------------------------------------------------


def _blend(rgba):
    a = rgba[..., 3:]
    return rgba[..., :3] * a + (1 - a), rgba[..., 3] > 0.3


def reference_steps(run, before: dict, pool, poses, rays, rows, tf32: bool,
                    keep: int | None = None) -> steps.Record:
    """The reference's run of the compared steps from ``before`` on the
    pool's ``rows`` (one row tensor a step); ``keep`` images of each step
    alone, the mean over them, where given (a fault). Each image's loss
    reaches the ray MLP through the keys; the keys' gradient is gathered
    over the images and sent back through the ray MLP once a step."""
    pose = run.config["pose"]
    leaves = {k: v.clone().requires_grad_(True) for k, v in before.items()}
    params = steps.unflatten(leaves)
    order = list(leaves)
    lrs = [1e-3 if k.startswith("backbone/") else 4e-3 for k in order]
    adam = Adam([leaves[k] for k in order], lrs, BETAS)
    rec = steps.Record(params)
    rec.before = {k: v.detach().clone() for k, v in before.items()}
    ori, dirs, rgb = rays[0], -rays[1], rays[2]
    with precision(tf32):
        for i, row in enumerate(rows):
            row = row[:keep] if keep else row
            imgs, masks = _blend(pool[row])
            feats = ref.ray_features(params, pose, ori, dirs, rgb)
            feats_in = feats.detach().requires_grad_(True)
            k = feats_in @ params["k_proj"]["w"] + params["k_proj"]["b"]
            total = 0.0
            for j in range(row.shape[0]):
                loss = ref.id_loss(params, pose, imgs[j], masks[j],
                                   poses[row[j]], ori, dirs, k)
                if torch.isfinite(loss):
                    (loss / row.shape[0]).backward(retain_graph=True)
                    total += float(loss.detach())
            feats.backward(feats_in.grad)
            rec.losses.append(total / row.shape[0])
            if i == 0:
                rec.grad1 = {k_: leaves[k_].grad.detach().clone()
                             for k_ in order}
            adam.step()
    rec.after = {k: v.detach().clone() for k, v in leaves.items()}
    return rec


def check(run, st) -> dict:
    record, pool, poses, rays = st.record, st.pool, st.poses, st.rays
    for name in ("params", "opt"):
        delattr(st, name)
    if run.dev.type == "cuda":
        torch.cuda.empty_cache()
    want = reference_steps(run, record.before, pool, poses, rays,
                           record.feeds, tf32=False)
    return steps.gaps(record, want)


def control(run) -> dict:
    """Readings of the control (the reference in TF32 in the program's
    place) and of half the batch left out, at the cell's size."""
    params, pool, poses, rays = inputs(run)
    before = {k: v for k, v in steps.named(params)}
    rng = np.random.default_rng(run.seed)
    accum = run.config["pose"]["id_accum"]
    rows = [torch.as_tensor(rng.integers(0, pool.shape[0], accum),
                            device=run.dev)
            for _ in range(run.traffic["compared"])]
    want = reference_steps(run, before, pool, poses, rays, rows, False)
    low = reference_steps(run, before, pool, poses, rays, rows, True)
    half = reference_steps(run, before, pool, poses, rays, rows, False,
                           keep=accum // 2)
    return {"control": steps.gaps(low, want), "half_batch": steps.gaps(half, want)}
