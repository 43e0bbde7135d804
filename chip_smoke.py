#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

Builds the port's kernels from ``iffnerf_tpu_torch/csrc``, holds each
against its plain PyTorch version at the main path's shapes, drives the
single-image pose estimate at full width (ViT-S/14 depth 12, 224 crop,
540 000 candidate rays, top-100; random weights from a seed, no
checkpoint) through the entry points a user calls, checks what comes out,
and times kernels and estimates with CUDA events. Each phase prints one
JSON line; then come the card's name and power limit (as nvidia-smi gives
them), the kernels line, and last ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result; so does a run without CUDA or without the package beside it.

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

from iffnerf_tpu_torch.device import resolve_device
from iffnerf_tpu_torch.ops import _build
from iffnerf_tpu_torch.ops.banked_attention import (
    banked_scores_fused,
    banked_scores_plain,
)
from iffnerf_tpu_torch.ops.fused_ray_attention import (
    fused_ray_scores,
    fused_ray_scores_plain,
    scaled_queries,
)
from iffnerf_tpu_torch.ops.topk import exact_topk
from iffnerf_tpu_torch.pose.id_module import (
    IDConfig,
    image_queries,
    init_id_module,
    ray_bank,
    ray_mlp_inputs,
)
from iffnerf_tpu_torch.pose.solve import (
    estimate_pose_single,
    estimate_pose_single_banked,
    solve_pose_from_topk,
)

SEED = 0
N_RAYS = 20000 * 27      # 20k surface points x 27 isocell directions
RAGGED = 1021            # a ray count no tile divides
K_TOP = 100
N_WARM, N_TIMED = 2, 10  # estimates per route: warm-up, then timed
REPS = 10                # timed kernel calls (median)
N_PROFILE = 3            # profiled estimates per route
# H100 SXM datasheet peaks (dense): bf16 tensor cores, float32 FMA, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
UP = (0.0, 0.0, 1.0)
# K2 against its plain version, relative (see score_tol): float32 summation
# order; in bf16 an activation's rounding can flip, which moves a score by
# well under 1e-3 of itself (at most 6.7e-4 at 540 000 rays on an H100)
K2_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
# the bf16 fused estimate against the plain torch route, another function
# (see phase_fused_estimate): score rtol and least top-100 overlap. Its
# scaled queries differ by a bf16 rounding (2^-9) and a bf16 divisor (19.625
# for sqrt(384), 1.5e-3 off), which move a score by that times its logits'
# spread: at most 1.7e-3 of itself at 540 000 rays on an H100, beside K2's
# own rounding flips (under 1e-3)
PLAIN_ROUTE_RTOL = 3e-3
PLAIN_ROUTE_OVERLAP = 90


def check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = REPS) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after two warm-ups."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    return statistics.median(ts)


def errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    diff = (got - want).abs()
    return {"max_abs_err": float(diff.max()),
            "max_rel_err": float((diff / want.abs().clamp_min(1e-30)).max()),
            "top100": overlap(got, want)}


def score_tol(rtol: float, patch_valid: torch.Tensor, r: int) -> dict:
    """allclose bounds for the scores of ``r`` rays: ``rtol``, and an atol
    of rtol times the mean score. The scores sum to the number of valid
    patches (at most 256), so at 540 000 rays a fixed atol such as 2e-3
    would be many times a typical score and hold nothing."""
    return {"rtol": rtol, "atol": rtol * max(int(patch_valid.sum()), 1) / r}


def overlap(a: torch.Tensor, b: torch.Tensor, k: int = K_TOP) -> int:
    ia = set(exact_topk(a, k)[1].tolist())
    ib = set(exact_topk(b, k)[1].tolist())
    return len(ia & ib)


def blob_mask(h, w, dev):
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    cy, cx = h / 2 + 30, w / 2 - 40
    return ((yy - cy) ** 2 / (h / 4) ** 2 + (xx - cx) ** 2 / (w / 4) ** 2) < 1.0


def make_scene(dev):
    g = torch.Generator(device=dev).manual_seed(SEED)
    ro = torch.rand((N_RAYS, 3), generator=g, device=dev) * 2 - 1
    rd = torch.randn((N_RAYS, 3), generator=g, device=dev)
    rd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    rr = torch.rand((N_RAYS, 3), generator=g, device=dev)
    imgs = torch.rand((N_WARM + N_TIMED, 800, 800, 3), generator=g, device=dev)
    return ro, rd, rr, imgs, blob_mask(800, 800, dev)


# ---------------------------------------------------------------------------
# library yardsticks: the same functions from torch.matmul and elementwise
# calls in the working dtype; timed only, never called by the port
# ---------------------------------------------------------------------------


def library_banked(bank, q, pv):
    # [P, R] logits, softmax over the last axis, as the JAX XLA path lays
    # them out (a softmax over the first axis of [R, P] is ~100x slower)
    logits = torch.matmul(q.to(bank.dtype), bank.T).float() / math.sqrt(bank.shape[1])
    return pv.float() @ torch.softmax(logits, dim=-1)


def library_fused(params, q, pv, x):
    def lin(h, p):
        return torch.matmul(h, p["w"].to(h.dtype)) + p["b"].to(h.dtype)

    h = torch.relu(lin(x, params["ray_mlp"][0]))
    h = torch.relu(lin(h, params["ray_mlp"][1]))
    h = torch.relu(lin(torch.cat([h, x], dim=-1), params["ray_mlp2"][0]))
    k = lin(lin(h, params["ray_mlp2"][1]), params["k_proj"])
    logits = torch.matmul(scaled_queries(q, x.dtype).T, k.T).float()  # [P, R]
    return pv.float() @ torch.softmax(logits, dim=-1)


# ---------------------------------------------------------------------------
# bounds: the least time the card could take, from this run's shapes
# ---------------------------------------------------------------------------


def bound(bytes_: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def banked_bound(bank, q):
    r, d = bank.shape
    p = q.shape[0]
    es = bank.element_size()
    return bound(r * d * es + p * d * es + p + r * 4, 2.0 * r * d * p,
                 bank.dtype)


def fused_bound(cfg, x, q):
    r = x.shape[0]
    p = q.shape[0]
    d, fc, ind = cfg.img_num_features, cfg.ray_feature_c, cfg.ray_in_dim
    layers = [(ind, fc), (fc, fc), (fc + ind, fc), (fc, d), (d, d)]
    macs = sum(i * o for i, o in layers) + d * p
    w_elems = sum(i * o + o for i, o in layers) + d * p
    es = x.element_size()
    return bound(x.numel() * es + w_elems * es + p + r * 4, 2.0 * r * macs,
                 x.dtype)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    t0 = time.perf_counter()
    built = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = []
    for name in _build.KERNELS:
        log = _build.library_path(name).with_suffix(".so.log")
        if log.exists():
            ptxas += [ln.strip() for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln]
    emit(phase="device", card=card_line(), kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=build_s,
         nvcc_s={k: round(v, 3) for k, v in built.items()}, ptxas=ptxas)


def phase_banked_kernel(params, cfgs, img, mask, rays):
    """K1 against its plain version: f32 and bf16 banks, full and ragged
    ray counts, a mask with invalid patches and an all-invalid one."""
    errs = {}
    for cfg in cfgs:
        bank = ray_bank(params, cfg, *rays)
        q, pv, _ = image_queries(params, cfg, img, mask)
        check(0 < int(pv.sum()) < pv.numel(), "mask leaves some patches invalid")
        for r in (N_RAYS, RAGGED):
            b = bank[:r]
            got = banked_scores_fused(b, q, pv)
            torch.cuda.synchronize()
            want = banked_scores_plain(b, q, pv)
            # rtol 2e-5: float32 accumulation order (tests/test_banked_pose.py)
            tol = score_tol(2e-5, pv, r)
            e = dict(errors(got, want), **tol)
            check(torch.allclose(got, want, **tol),
                  f"K1 {cfg.compute_dtype} R={r}: {e}")
            check(e["top100"] == K_TOP, f"K1 {cfg.compute_dtype} R={r}: {e}")
            errs[f"{cfg.compute_dtype}/{r}"] = e
        none = banked_scores_fused(bank[:RAGGED], q, torch.zeros_like(pv))
        check(not bool(none.any()), "K1 all-invalid mask gives zero scores")
    emit(phase="banked_kernel_check", results=errs)
    return errs


def phase_fused_kernel(params, cfgs, img, mask, rays):
    """K2 against its plain version: f32 and bf16, full and ragged."""
    errs = {}
    for cfg in cfgs:
        x = ray_mlp_inputs(cfg, *rays)
        q, pv, _ = image_queries(params, cfg, img, mask)
        for r in (N_RAYS, RAGGED):
            got = fused_ray_scores(params, q, pv, x[:r])
            torch.cuda.synchronize()
            want = fused_ray_scores_plain(params, q, pv, x[:r])
            tol = score_tol(K2_RTOL[cfg.compute_dtype], pv, r)
            e = dict(errors(got, want), **tol)
            check(torch.allclose(got, want, **tol),
                  f"K2 {cfg.compute_dtype} R={r}: {e}")
            check(e["top100"] == K_TOP, f"K2 {cfg.compute_dtype} R={r}: {e}")
            errs[f"{cfg.compute_dtype}/{r}"] = e
    emit(phase="fused_kernel_check", results=errs)
    return errs


def _check_pose(c2w, tag):
    check(bool(torch.isfinite(c2w).all()), f"{tag}: c2w finite")
    rot = c2w[:3, :3].double()
    eye = torch.eye(3, dtype=torch.float64, device=rot.device)
    dev_ = float((rot.T @ rot - eye).abs().max())
    check(dev_ < 1e-4, f"{tag}: rotation orthonormal ({dev_})")


def _drive(estimate, imgs):
    """Runs ``estimate(img)`` over the images, host-timed to the end of
    each; -> (outputs, per-image ms of the timed ones)."""
    outs, ms = [], []
    for i in range(imgs.shape[0]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = estimate(imgs[i])
        torch.cuda.synchronize()
        if i >= N_WARM:
            ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    return outs, ms


def _reset_counts():
    banked_scores_fused.launches = 0
    fused_ray_scores.launches = 0


def _counts():
    return {"banked_scores": banked_scores_fused.launches,
            "fused_ray_scores": fused_ray_scores.launches}


def _compare_routes(outs, refs, tag, min_overlap=K_TOP, c2w_tol=1e-4):
    """Checks each estimate's pose, its top-100 overlap with the reference
    estimate's and (unless ``c2w_tol`` is None) their c2w difference;
    -> (largest c2w difference, smallest overlap)."""
    worst, min_ov = 0.0, K_TOP
    for i, ((c2w, s, idx, _), (c2w_r, s_r, idx_r, _)) in enumerate(zip(outs, refs)):
        _check_pose(c2w, f"{tag} image {i}")
        ov = len(set(idx.tolist()) & set(idx_r.tolist()))
        diff = float((c2w - c2w_r).abs().max())
        worst, min_ov = max(worst, diff), min(min_ov, ov)
        check(ov >= min_overlap, f"{tag} image {i}: top-100 overlap {ov}")
        check(c2w_tol is None or diff <= c2w_tol,
              f"{tag} image {i}: c2w differs by {diff}")
    return worst, min_ov


def _score_errors(outs, refs, rtol, patch_valid):
    """Largest abs and rel score differences of the estimates from the
    reference's, and whether all lie within ``score_tol(rtol)``."""
    abs_err, rel_err, ok = 0.0, 0.0, True
    for (_, s, _, _), (_, s_r, _, _) in zip(outs, refs):
        e = errors(s, s_r)
        abs_err = max(abs_err, e["max_abs_err"])
        rel_err = max(rel_err, e["max_rel_err"])
        ok = ok and torch.allclose(s, s_r, **score_tol(rtol, patch_valid,
                                                       s.shape[0]))
    return abs_err, rel_err, ok


def phase_banked_estimate(params, cfg, imgs, mask, rays):
    """The main path: one bank per object, then per-image estimates."""
    ro, rd, rr = rays
    t0 = time.perf_counter()
    bank = ray_bank(params, cfg, ro, rd, rr)
    torch.cuda.synchronize()
    bank_ms = (time.perf_counter() - t0) * 1e3
    _reset_counts()
    outs, ms = _drive(lambda img: estimate_pose_single_banked(
        params, cfg, img, mask, bank, ro, rd, UP, k=K_TOP), imgs)
    counts = _counts()
    check(counts["banked_scores"] == imgs.shape[0],
          f"banked kernel launched once per estimate: {counts}")
    exact = IDConfig(compute_dtype=cfg.compute_dtype, fused_bank=False)
    refs, _ = _drive(lambda img: estimate_pose_single_banked(
        params, exact, img, mask, bank, ro, rd, UP, k=K_TOP), imgs)
    worst, min_ov = _compare_routes(outs, refs, "banked estimate")
    emit(phase="banked_estimate", compute_dtype=cfg.compute_dtype,
         n_rays=N_RAYS, images=imgs.shape[0], launches=counts,
         bank_build_ms=bank_ms, ms_per_image_median=statistics.median(ms),
         ms_per_image=ms, c2w_max_diff_vs_exact=worst, top100_min_overlap=min_ov)
    return counts, statistics.median(ms)


def _estimate_with_plain_k2(params, cfg, img, mask, rays):
    """The fused-scoring estimate with K2's plain version in the kernel's
    place: the same function, to hold the kernel's route to."""
    ro, rd, rr = rays
    q, pv, _ = image_queries(params, cfg, img, mask)
    scores = fused_ray_scores_plain(params, q, pv, ray_mlp_inputs(cfg, ro, rd, rr))
    w, idx = exact_topk(scores, K_TOP)
    up = torch.tensor(UP, dtype=torch.float32, device=ro.device)
    return solve_pose_from_topk(ro[idx], rd[idx], w, up), scores, idx, w


def phase_fused_estimate(params, cfg, imgs, mask, rays):
    """The unbanked route with fused_scoring: the ray chain per image.

    Held to the same estimate through K2's plain version: scores within
    K2's bound, the same top-100, c2w within 1e-4. Held to the plain torch
    route (fused_scoring=False): in float32 the same, as
    tests/test_fused_scoring.py holds the JAX package. In bfloat16 the two
    routes compute different functions: K2 rounds the scaled queries to
    bf16 (the TPU kernel's design) where the plain route divides the
    float32 logits, so scores move by up to PLAIN_ROUTE_RTOL of themselves
    and the near-equal scores of random weights can reorder. There the
    top-100 overlap must reach PLAIN_ROUTE_OVERLAP and c2w is not held."""
    ro, rd, rr = rays
    dt = cfg.compute_dtype
    f32 = dt == "float32"
    fused = IDConfig(compute_dtype=dt, fused_scoring=True)
    pv = image_queries(params, cfg, imgs[0], mask)[1]
    _reset_counts()
    outs, ms = _drive(lambda img: estimate_pose_single(
        params, fused, img, mask, ro, rd, rr, UP, k=K_TOP), imgs)
    counts = _counts()
    same_fn = [_estimate_with_plain_k2(params, cfg, img, mask, rays)
               for img in imgs]
    unfused, plain_ms = _drive(lambda img: estimate_pose_single(
        params, cfg, img, mask, ro, rd, rr, UP, k=K_TOP), imgs)
    k2_abs, k2_rel, k2_ok = _score_errors(outs, same_fn, K2_RTOL[dt], pv)
    plain_rtol = K2_RTOL[dt] if f32 else PLAIN_ROUTE_RTOL
    pl_abs, pl_rel, pl_ok = _score_errors(outs, unfused, plain_rtol, pv)
    emit(phase="fused_estimate", compute_dtype=dt,
         n_rays=N_RAYS, images=imgs.shape[0], launches=counts,
         ms_per_image_median=statistics.median(ms), ms_per_image=ms,
         plain_route_ms_per_image_median=statistics.median(plain_ms),
         score_max_abs_err_vs_plain_k2=k2_abs,
         score_max_rel_err_vs_plain_k2=k2_rel,
         score_max_abs_err_vs_plain_route=pl_abs,
         score_max_rel_err_vs_plain_route=pl_rel)
    check(counts["fused_ray_scores"] == imgs.shape[0],
          f"fused kernel launched once per estimate: {counts}")
    check(k2_ok, f"fused estimate scores vs plain K2 ({dt})")
    check(pl_ok, f"fused estimate scores vs plain route ({dt})")
    worst_k2, _ = _compare_routes(outs, same_fn, "fused estimate vs plain K2")
    worst, min_ov = _compare_routes(
        outs, unfused, "fused estimate vs plain route",
        min_overlap=K_TOP if f32 else PLAIN_ROUTE_OVERLAP,
        c2w_tol=1e-4 if f32 else None)
    emit(phase="fused_estimate_poses", compute_dtype=dt,
         c2w_max_diff_vs_plain_k2=worst_k2,
         c2w_max_diff_vs_plain_route=worst, top100_min_overlap=min_ov)
    return counts, statistics.median(ms)


def phase_profile(estimates, imgs):
    """Where an estimate's time goes: torch.profiler over a few estimates
    of each route -> host ms and kernel ms per image, the device's busy
    share (kernel time over host time, profiler on) and the kernels that
    take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in estimates.items():
        fn(imgs[0])
        torch.cuda.synchronize()
        batch = imgs[1:1 + N_PROFILE]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for img in batch:
                fn(img)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / len(batch)
        kernels = sorted(
            (e for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)),
            key=lambda e: -e.self_device_time_total)
        dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / len(batch)
        check(dev_ms > 0, f"profile {name}: the profiler saw device time")
        out[name] = {
            "host_ms_per_image": host_ms, "device_ms_per_image": dev_ms,
            "device_busy_share": dev_ms / host_ms,
            "top_kernels_ms_per_image": {
                e.key[:80]: e.self_device_time_total / 1e3 / len(batch)
                for e in kernels[:8]}}
    emit(phase="profile", images_per_route=N_PROFILE, routes=out)
    return out


def phase_times(params, cfgs, img, mask, rays):
    """Kernel, plain and library times at the main path's shapes."""
    rows = {}
    for cfg in cfgs:
        bank = ray_bank(params, cfg, *rays)
        x = ray_mlp_inputs(cfg, *rays)
        q, pv, _ = image_queries(params, cfg, img, mask)
        b_ms, b_by = banked_bound(bank, q)
        f_ms, f_by = fused_bound(cfg, x, q)
        rows[f"banked_scores/{cfg.compute_dtype}"] = {
            "ms": time_ms(lambda: banked_scores_fused(bank, q, pv)),
            "plain_ms": time_ms(lambda: banked_scores_plain(bank, q, pv)),
            "library_ms": time_ms(lambda: library_banked(bank, q, pv)),
            "bound_ms": b_ms, "bound_by": b_by}
        rows[f"fused_ray_scores/{cfg.compute_dtype}"] = {
            "ms": time_ms(lambda: fused_ray_scores(params, q, pv, x)),
            "plain_ms": time_ms(lambda: fused_ray_scores_plain(params, q, pv, x)),
            "library_ms": time_ms(lambda: library_fused(params, q, pv, x)),
            "bound_ms": f_ms, "bound_by": f_by}
        del bank, x
        torch.cuda.empty_cache()
    emit(phase="times", n_rays=N_RAYS, reps=REPS, rows=rows)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = resolve_device("cuda")
    phase_device()

    cfg16 = IDConfig(compute_dtype="bfloat16")
    cfg32 = IDConfig()
    params = init_id_module(torch.Generator().manual_seed(SEED), cfg16,
                            device=dev)
    ro, rd, rr, imgs, mask = make_scene(dev)
    rays = (ro, rd, rr)
    img0 = imgs[0]

    k1_errs = phase_banked_kernel(params, (cfg32, cfg16), img0, mask, rays)
    k2_errs = phase_fused_kernel(params, (cfg32, cfg16), img0, mask, rays)
    k1_counts, banked_ms = phase_banked_estimate(params, cfg16, imgs, mask, rays)
    k2_counts, fused_ms = phase_fused_estimate(params, cfg16, imgs, mask, rays)
    phase_fused_estimate(params, cfg32, imgs[:N_WARM + 3], mask, rays)
    rows = phase_times(params, (cfg16, cfg32), img0, mask, rays)
    bank = ray_bank(params, cfg16, ro, rd, rr)
    fused16 = IDConfig(compute_dtype="bfloat16", fused_scoring=True)
    phase_profile({
        "banked": lambda img: estimate_pose_single_banked(
            params, cfg16, img, mask, bank, ro, rd, UP, k=K_TOP),
        "fused": lambda img: estimate_pose_single(
            params, fused16, img, mask, ro, rd, rr, UP, k=K_TOP)}, imgs)
    del bank

    n_est = N_WARM + N_TIMED
    kernels = [
        dict(name="banked_scores", route="cuda",
             source="iffnerf_tpu_torch/csrc/banked_attention.cu",
             replaces="iffnerf_tpu/ops/banked_attention.py:97",
             launches=k1_counts["banked_scores"],
             launches_per_estimate=k1_counts["banked_scores"] / n_est,
             max_abs_err=k1_errs[f"bfloat16/{N_RAYS}"]["max_abs_err"],
             **rows["banked_scores/bfloat16"]),
        dict(name="fused_ray_scores", route="cuda",
             source="iffnerf_tpu_torch/csrc/fused_ray_attention.cu",
             replaces="iffnerf_tpu/ops/fused_ray_attention.py:90",
             launches=k2_counts["fused_ray_scores"],
             launches_per_estimate=k2_counts["fused_ray_scores"] / n_est,
             max_abs_err=k2_errs[f"bfloat16/{N_RAYS}"]["max_abs_err"],
             **rows["fused_ray_scores/bfloat16"]),
    ]
    emit(phase="latency", banked_ms_per_image=banked_ms,
         fused_ms_per_image=fused_ms)
    print(card_line(), flush=True)
    emit(kernels=kernels)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
