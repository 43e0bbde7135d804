"""An offline pose sweep: one estimate a frame against a ray bank, frames
dispatched ahead.

Set-up draws the ID module's weights, ``frames`` distinct frames with
object masks and a candidate set shaped as ``explore_field``'s, and builds
the bank once (``id_module.ray_bank``). A unit is one frame through
``pose/solve.py::estimate_pose_single_banked`` (frame i is distinct frame
i mod ``frames``); its c2w is copied without blocking into pinned host
memory and read once ``in_flight`` more frames have been issued. The
frames whose outputs the reference checks are drawn from the seed among
the first ``check_within``.
"""

from __future__ import annotations

import collections
import contextlib
import time

import numpy as np
import torch

from portbench import counts as cnt
from portbench import make
from portbench.reference import pose as ref
from portbench.reference import precision


def id_config(pose: dict, compute_dtype: str, fused_bank: bool):
    from iffnerf_tpu_torch.pose.id_module import IDConfig
    from iffnerf_tpu_torch.pose.vit import ViTConfig

    vit = pose["vit"]
    return IDConfig(
        backbone=ViTConfig(img_size=vit["img_size"],
                           patch_size=vit["patch_size"], dim=vit["dim"],
                           depth=vit["depth"], num_heads=vit["num_heads"],
                           mlp_ratio=vit["mlp_ratio"]),
        resize_size=pose["resize_size"], crop_size=pose["crop_size"],
        pe_freqs=pose["pe_freqs"], ray_view_pe=pose["ray_view_pe"],
        ray_pos_pe=pose["ray_pos_pe"], ray_rgb_pe=pose["ray_rgb_pe"],
        ray_feature_c=pose["ray_feature_c"],
        mask_threshold=pose["mask_threshold"], compute_dtype=compute_dtype,
        fused_bank=fused_bank)


class State:
    pass


def inputs(run):
    """The cell's inputs from the seed: (ID weights, frames, masks, rays,
    the frame positions the reference checks)."""
    pose, tr = run.config["pose"], run.traffic
    params = make.id_params(run.seed, run.dev, pose)
    imgs, masks = make.frames(run.seed, run.dev, tr["frames"],
                              *tr["frame_hw"])
    rays = make.candidate_rays(run.seed, run.dev, pose["gen_points"],
                               pose["isocell_dirs"])
    keep = np.random.default_rng(run.seed).choice(
        tr["check_within"], tr["check_frames"], replace=False)
    return params, imgs, masks, rays, {int(i) for i in keep}


def prepare(run):
    from iffnerf_tpu_torch.pose.id_module import ray_bank

    pose, tr = run.config["pose"], run.traffic
    st = State()
    st.run = run
    st.cfg = id_config(pose, tr["compute_dtype"], tr["fused_bank"])
    st.params, st.imgs, st.masks, st.rays, st.keep = inputs(run)
    st.bank = ray_bank(st.params, st.cfg, *st.rays, device=run.dev)
    st.up = torch.tensor(tr["model_up"], device=run.dev)
    st.k = pose["k"]
    st.in_flight = tr["in_flight"]
    pin = run.dev.type == "cuda"
    st.slots = [torch.empty((4, 4), pin_memory=pin)
                for _ in range(st.in_flight + 1)]
    st.pending = collections.deque()
    st.kept = {}
    st.issued = st.failed = 0
    st.call_s, st.calls = 0.0, 0
    for _ in range(tr["warm_frames"]):
        _issue(st, record=False)
    drain(st)
    st.issued = st.failed = 0
    st.call_s, st.calls = 0.0, 0
    return st


def _issue(st, record=True):
    from iffnerf_tpu_torch.pose.solve import estimate_pose_single_banked

    i = st.issued
    n = st.imgs.shape[0]
    t = time.perf_counter()
    c2w, scores, idx, _ = estimate_pose_single_banked(
        st.params, st.cfg, st.imgs[i % n], st.masks[i % n], st.bank,
        st.rays[0], st.rays[1], st.up, k=st.k, device=st.run.dev)
    st.call_s += time.perf_counter() - t
    st.calls += 1
    slot = st.slots[i % len(st.slots)]
    slot.copy_(c2w, non_blocking=True)
    ev = torch.cuda.Event() if st.run.dev.type == "cuda" else None
    if ev is not None:
        ev.record()
    st.pending.append((ev, slot))
    if record and i in st.keep:
        st.kept[i] = (c2w, scores, idx)
    st.issued += 1
    while len(st.pending) > st.in_flight:
        _complete(st)


def _complete(st):
    ev, slot = st.pending.popleft()
    if ev is not None:
        ev.synchronize()
    if not bool(torch.isfinite(slot).all()):
        st.failed += 1


def unit(st):
    _issue(st)


def drain(st):
    while st.pending:
        _complete(st)


def tally(st):
    return st.issued, st.failed


@contextlib.contextmanager
def traced_hooks(st):
    """A span round each call into the image side."""
    from iffnerf_tpu_torch.pose import solve

    inner = solve.image_queries

    def spanned(*a, **kw):
        with torch.profiler.record_function("portbench.image_queries"):
            return inner(*a, **kw)

    solve.image_queries = spanned
    try:
        yield
    finally:
        solve.image_queries = inner


def host(st):
    return {"call_ms": st.call_s / max(st.calls, 1) * 1e3}


def counts(st):
    pose = st.run.config["pose"]
    rays = pose["gen_points"] * pose["isocell_dirs"]
    return {"flops_per_unit": cnt.pose_frame_flops(pose, rays),
            "k1_least_s": cnt.k1_least_s(pose, rays)}


def marks(st):
    return {}


# --------------------------------------------------------------------------
# the comparison
# --------------------------------------------------------------------------


def compare(rays, up, got, want_scores) -> dict:
    """The numbers compared for one frame: ``got`` = (c2w, scores, top-k
    indices) of the side under test, ``want_scores`` the reference's
    scores. score_rel: the widest score gap over the largest reference
    score; topk_gap: over the reference's k-th best score, the larger of
    the widest gap between the chosen rays' scores and their reference
    scores and how far below that k-th score the lowest of the chosen rays
    lies in the reference (a wrong ray); c2w_gap: the widest entry gap of
    c2w against the reference's solve of the chosen rays with their
    reference scores."""
    c2w, s, idx = (t.detach().cpu() for t in got)
    want = want_scores.detach().cpu()
    k = idx.shape[0]
    kth = want[ref.topk(want, k)[-1]]
    chosen = want[idx]
    ori, dirs = (r.detach().cpu()[idx].numpy() for r in rays[:2])
    solved = ref.solve(ori, dirs, chosen.numpy(), up.detach().cpu().numpy())
    return {"score_rel": float((s - want).abs().max() / want.max()),
            "topk_gap": float(max(torch.clamp(kth - chosen.min(), min=0),
                                  (s[idx] - chosen).abs().max()) / kth),
            "c2w_gap": float(np.abs(c2w.double().numpy() - solved).max())}


def reference_frames(run, params, imgs, masks, rays, positions, tf32: bool,
                     solve_side: bool):
    """The reference's scores of the frames at ``positions`` (and, with
    ``solve_side``, its own top-k and c2w of them, as the side under test
    in a control run) -> {position: (scores, got or None)}."""
    pose, tr = run.config["pose"], run.traffic
    up = torch.tensor(tr["model_up"])
    out = {}
    with torch.no_grad(), precision(tf32):
        keys = ref.keys(params, pose, *rays)
        n = imgs.shape[0]
        for i in positions:
            q, valid = ref.queries(params, pose, imgs[i % n], masks[i % n])
            s = ref.scores(q, valid, keys)
            got = None
            if solve_side:
                idx = ref.topk(s, pose["k"])
                c2w = ref.solve(rays[0].cpu()[idx].numpy(),
                                rays[1].cpu()[idx].numpy(),
                                s.cpu()[idx].numpy(), up.numpy())
                got = (torch.as_tensor(c2w), s, idx)
            out[i] = (s, got)
    return out


def worst(rows: list) -> dict:
    return {k: max(r[k] for r in rows) for k in rows[0]}


def check(run, st) -> dict:
    kept = {i: tuple(t.detach() for t in v) for i, v in st.kept.items()}
    if not kept:
        raise RuntimeError("no checked frame was reached in the window")
    params, imgs, masks, rays = st.params, st.imgs, st.masks, st.rays
    del st.bank, st.kept
    if run.dev.type == "cuda":
        torch.cuda.empty_cache()
    want = reference_frames(run, params, imgs, masks, rays, sorted(kept),
                            tf32=False, solve_side=False)
    return worst([compare(rays, st.up, kept[i],
                          want[i][0]) for i in sorted(kept)])


def control(run) -> dict:
    """Readings of the control (the reference in TF32 in the program's
    place) at the cell's size, on the frames a run would check."""
    params, imgs, masks, rays, keep = inputs(run)
    pos = sorted(keep)
    want = reference_frames(run, params, imgs, masks, rays, pos, False, False)
    low = reference_frames(run, params, imgs, masks, rays, pos, True, True)
    up = torch.tensor(run.traffic["model_up"])
    return {"control": worst([compare(rays, up, low[i][1], want[i][0])
                                for i in pos])}

