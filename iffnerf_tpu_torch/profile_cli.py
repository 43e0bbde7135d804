"""FLOPs and latency of the port's programs: the counterpart of the JAX
package's ``profile_performance.py`` (reference profile_performance.py:
47-191), with the same sections under the same labels.

    python -m iffnerf_tpu_torch.profile_cli --config configs/lego.txt \\
        [--trace DIR] [--pose 1] [--device cpu]

Sections: the render forward (``render_rays``, eval mode) on ``batch_size``
random rays; the train step (forward, backward, Adam; the L1 term only);
fifty steps in a row with one synchronize; with ``--pose 1`` the pose
program at 540 000 rays, bf16, an 800x800 image, random weights and k =
100 (the exact route, or K2's fused route with ``IFFNERF_FUSED_POSE=1``)
and the banked program (the bank built once, then the ViT, K1, the exact
top-k and the solve); with ``--trace DIR`` a ``torch.profiler`` trace of
5 train steps written to ``DIR/trace.json``.

Latency is ``amortized_ms``' median host time a call, with the CUDA-event
time of the same calls beside it. FLOPs are counted by
``torch.utils.flop_counter.FlopCounterMode``, split by the matmuls' dtype:
it counts matmul-class operations only and sees nothing inside the port's
own kernels, so a program whose scoring runs in a kernel is counted on its
exact route at the same shapes, its kernel's part as bf16 products (K1
and K2 multiply in bf16 on the tensor cores; the port's torch matmuls of
bf16 operands upcast to float32, as XLA's do). Each program's share is
the time its counted FLOPs need at the H100 SXM's published peaks (bf16
on the tensor cores, float32 on the FMA units: the port runs float32
matmuls with TF32 off) over its measured time; on the CPU it is n/a.
Bytes moved are not counted (XLA's ``bytes accessed`` has no
counterpart): each line says ``bytes n/a``. The JAX package's device-resident scan of steps is a TPU
dispatch device, not ported: its section here is steps called in a row.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import statistics
import time

import numpy as np
import torch

from iffnerf_tpu_torch.config import config_parser
from iffnerf_tpu_torch.device import (
    H100_PEAK_BYTES,
    H100_PEAK_FLOPS,
    card_line,
    resolve_device,
    trainable,
)

# csrc/banked_attention.cu: a stats pass, then a score pass that
# recomputes each logits tile, so K1 does the logits' products twice
K1_PASSES = 2


def flops_to_string(flops: float) -> str:
    """(reference utils.py:237-251)"""
    for unit, div in (("TFLOPs", 1e12), ("GFLOPs", 1e9), ("MFLOPs", 1e6)):
        if flops >= div:
            return f"{flops / div:.2f} {unit}"
    return f"{flops:.0f} FLOPs"


def count_flops(fn) -> dict:
    """Runs ``fn`` once under ``FlopCounterMode`` -> its matmul-class
    FLOPs by peak ("bfloat16" for bf16 and float16 operands, "float32"
    otherwise)."""
    from torch.utils.flop_counter import FlopCounterMode, flop_registry

    tally = collections.Counter()

    def by_dtype(formula):
        def count(*args, out_val=None, **kwargs):
            n = formula(*args, out_val=out_val, **kwargs)
            dtype = next(a.dtype for a in args if isinstance(a, torch.Tensor))
            half = dtype in (torch.bfloat16, torch.float16)
            tally["bfloat16" if half else "float32"] += n
            return n

        count._get_raw = True  # FlopCounterMode passes the tensors
        return count

    with FlopCounterMode(display=False, custom_mapping={
            op: by_dtype(f) for op, f in flop_registry.items()}):
        fn()
    return {"bfloat16": tally["bfloat16"], "float32": tally["float32"]}


def mfu(flops: dict, ms: float, on_card: bool) -> dict:
    """Achieved TFLOP/s and the share of the measured time that the
    counted FLOPs need at the H100's peaks (None off the card)."""
    total = sum(flops.values())
    ideal_s = sum(n / H100_PEAK_FLOPS[k] for k, n in flops.items())
    return {"tflops": total / (ms * 1e-3) / 1e12,
            "share": ideal_s / (ms * 1e-3) if on_card else None}


def mfu_string(rec: dict) -> str:
    """The line under a section's: TFLOP/s, the share of the peaks' time
    and the FLOPs by dtype."""
    share = "n/a" if rec["share"] is None else f"{rec['share'] * 100:.2f}%"
    return (f"{rec['tflops']:.2f} TFLOP/s = {share} of the time at the H100"
            f" peaks (bf16 {flops_to_string(rec['flops']['bfloat16'])},"
            f" float32 {flops_to_string(rec['flops']['float32'])}); bytes"
            " n/a")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def amortized_ms(fn, dev: torch.device, reps: int = 20, rounds: int = 5):
    """Median host ms a call over ``rounds`` rounds of ``reps`` calls, one
    synchronize a round, after one warm call (profile_performance.py's
    ``amortized_ms``) -> (host ms, the CUDA-event ms of the same calls on
    the card, else None)."""
    fn()
    _sync(dev)
    host, device = [], []
    for _ in range(rounds):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if dev.type == "cuda":
            end.record()
        _sync(dev)
        host.append((time.perf_counter() - t0) / reps * 1e3)
        if dev.type == "cuda":
            device.append(start.elapsed_time(end) / reps)
    return (statistics.median(host),
            statistics.median(device) if device else None)


def _section(records, log, label, ms, device_ms, flops, dev, note=""):
    rec = {"section": label, "ms": ms, "device_ms": device_ms,
           "flops": flops, **mfu(flops, ms, dev.type == "cuda"),
           "note": note}
    records.append(rec)
    dev_s = "n/a" if device_ms is None else f"{device_ms:.3f} ms"
    log(f"{label}: {ms:.3f} ms (device {dev_s})  "
        f"{flops_to_string(sum(flops.values()))}"
        + (f"  [{note}]" if note else ""))
    log(f"          {mfu_string(rec)}")


def _extra_args(p):
    p.add_argument("--trace", type=str, default=None)
    p.add_argument("--pose", type=int, default=1,
                   help="also profile the pose programs")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")


def main(argv=None, *, n_rays: int = 20000 * 27, img_side: int = 800,
         depth: int = 12, k_top: int = 100, reps: int = 20,
         steps_in_row: int = 50, log=print) -> list:
    """Profiles the programs and prints their lines -> the sections'
    records (label, ms, device ms, FLOPs by dtype, TFLOP/s, share). The
    keywords size the pose programs (candidate rays, image side, ViT
    depth, top-k), the calls a timed round and the steps in a row."""
    from iffnerf_tpu_torch.models.field import init_field
    from iffnerf_tpu_torch.models.render import render_rays
    from iffnerf_tpu_torch.train.trainer import (
        field_config_from_args,
        make_optimizer,
        train_step,
    )
    from iffnerf_tpu_torch.utils.misc import N_to_reso, cal_n_samples

    args = config_parser(argv, extra_parser_hook=_extra_args, known_only=True)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        log(f"card: {card_line()}; H100 SXM peaks (dense): bf16 "
            f"{H100_PEAK_FLOPS['bfloat16'] / 1e12:.0f}, TF32 "
            f"{H100_PEAK_FLOPS['tf32'] / 1e12:.0f}, float32 "
            f"{H100_PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s, HBM "
            f"{H100_PEAK_BYTES / 1e12:.2f} TB/s")
    else:
        log(f"device: {dev}; peak shares n/a")
    records = []

    aabb = np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)
    reso = N_to_reso(args.N_voxel_init, aabb)
    n_samples = min(args.nSamples, cal_n_samples(reso, args.step_ratio))
    config = field_config_from_args(args, aabb, reso, (2.0, 6.0))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_field(gen, config)

    n = args.batch_size
    d = torch.randn((n, 3), generator=gen, device=dev)
    rays = torch.cat([torch.rand((n, 3), generator=gen, device=dev) * 6 - 3,
                      d / d.norm(dim=-1, keepdim=True),
                      torch.full((n, 1), 0.01, device=dev)], -1)
    rgbs = torch.rand((n, 4), generator=gen, device=dev)

    # ---- forward ----
    def forward():
        with torch.no_grad():
            return render_rays(config, params, None, rays, is_train=False,
                               white_bg=True, n_samples=n_samples)[0]

    ms, dms = amortized_ms(forward, dev, reps)
    _section(records, log, "forward", ms, dms, count_flops(forward), dev,
             f"{n} rays x {n_samples} samples")

    # ---- forward + backward (full train step) ----
    p = trainable(params, dev)
    opt = make_optimizer(p, args.lr_init, args.lr_basis, 0.9999)
    weights = {"l1": 8e-5, "tv_d": 0.0, "tv_a": 0.0}
    jitter = torch.Generator(device=dev).manual_seed(1)
    bg = torch.ones(3, device=dev)

    def step():
        return train_step(config, p, opt, None, rays, rgbs, bg, weights,
                          n_samples=n_samples, use_l1=True, gen=jitter)

    ms, dms = amortized_ms(step, dev, reps=10)
    _section(records, log, "train step (fwd+bwd+adam)", ms, dms,
             count_flops(step), dev)
    step_flops = records[-1]["flops"]

    # ---- steps in a row, one synchronize (the JAX scan's section) ----
    ms, dms = amortized_ms(step, dev, reps=steps_in_row, rounds=3)
    _section(records, log, f"train step (x{steps_in_row} in a row, one "
             "synchronize)", ms, dms, step_flops, dev,
             "ms an iteration; the JAX package's device-resident scan is a "
             "TPU dispatch device, not ported")

    if args.pose:
        _pose_sections(records, log, dev, n_rays, img_side, depth, k_top,
                       reps)

    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(5):
                step()
            _sync(dev)
        prof.export_chrome_trace(os.path.join(args.trace, "trace.json"))
        log(f"profiler trace written to {args.trace}")
    return records


def _pose_sections(records, log, dev, n_rays, img_side, depth, k_top, reps):
    """The pose program (exact, or K2's fused route with
    ``IFFNERF_FUSED_POSE=1``, read as profile_performance.py reads it) and
    the banked program."""
    from iffnerf_tpu_torch.pose.id_module import (
        IDConfig,
        image_queries,
        init_id_module,
        ray_bank,
        score_rays,
    )
    from iffnerf_tpu_torch.pose.solve import (
        estimate_pose_single,
        estimate_pose_single_banked,
    )
    from iffnerf_tpu_torch.pose.vit import ViTConfig

    fused = bool(int(os.environ.get("IFFNERF_FUSED_POSE", "0") or 0))
    cfg = IDConfig(backbone=ViTConfig(depth=depth),
                   compute_dtype="bfloat16", fused_scoring=fused)
    gen = torch.Generator(device=dev).manual_seed(7)
    pparams = init_id_module(torch.Generator().manual_seed(7), cfg,
                             device=dev)
    img = torch.rand((img_side, img_side, 3), generator=gen, device=dev)
    mask = torch.ones((img_side, img_side), dtype=torch.bool, device=dev)
    r_o = torch.rand((n_rays, 3), generator=gen, device=dev) * 2 - 1
    rd = torch.randn((n_rays, 3), generator=gen, device=dev)
    r_d = rd / rd.norm(dim=-1, keepdim=True)
    r_rgb = torch.rand((n_rays, 3), generator=gen, device=dev)
    up = torch.tensor([0.0, 0.0, 1.0], device=dev)

    def pose_once(c):
        with torch.no_grad():
            return estimate_pose_single(pparams, c, img, mask, r_o, r_d,
                                        r_rgb, up, k=k_top, device=dev)

    exact = dataclasses.replace(cfg, fused_scoring=False)
    with torch.no_grad():
        q, pv, _ = image_queries(pparams, cfg, img, mask)
    ms, dms = amortized_ms(lambda: pose_once(cfg), dev, reps)
    flops = count_flops(lambda: pose_once(exact))
    note = ""
    if fused:
        flops = _in_bf16(flops, count_flops(lambda: score_rays(
            pparams, exact, q, pv, r_o, r_d, r_rgb)))
        note = ("FLOPs counted on the exact route at the same shapes: K2 "
                "runs the ray MLP, the k projection and the logits inside "
                "a kernel, in bf16 products (counted so)")
    tag = "fused K2 scoring" if fused else "exact scoring"
    _section(records, log, f"pose program ({n_rays} rays, bf16, {tag})", ms,
             dms, flops, dev, note)

    # ---- the banked per-image program: ray keys built once an object;
    # an image costs the ViT, the bank's scoring, the exact top-k and the
    # solve
    with torch.no_grad():
        bank = ray_bank(pparams, cfg, r_o, r_d, r_rgb, device=dev)
    _sync(dev)

    def banked(c):
        with torch.no_grad():
            return estimate_pose_single_banked(pparams, c, img, mask, bank,
                                               r_o, r_d, up, k=k_top,
                                               device=dev)

    ms, dms = amortized_ms(lambda: banked(cfg), dev, reps)
    exact = dataclasses.replace(cfg, fused_bank=False)
    flops = _in_bf16(count_flops(lambda: banked(exact)), count_flops(
        lambda: score_rays(pparams, exact, q, pv, None, None, None,
                           bank=bank)))
    bank_mb = bank.numel() * bank.element_size() / 1e6
    _section(records, log,
             f"pose program BANKED ({bank.shape[0]} rays, bank {bank_mb:.0f}"
             f" MB {str(bank.dtype).replace('torch.', '')}, fused_bank="
             f"{cfg.fused_bank})", ms, dms, flops, dev,
             f"FLOPs counted once on the exact route (fused_bank=False) at "
             f"the same shapes, the logits as bf16 products: K1 forms them "
             f"inside a kernel that reads the bank in {K1_PASSES} passes "
             f"(csrc/banked_attention.cu), so it does them {K1_PASSES} times")


def _in_bf16(flops: dict, kernel: dict) -> dict:
    """``flops`` with the part a kernel does (``kernel``, counted on the
    exact route, where the port's matmuls upcast to float32) moved to
    bf16, the dtype of the kernel's products."""
    moved = sum(kernel.values())
    return {"bfloat16": flops["bfloat16"] + moved,
            "float32": flops["float32"] - moved}


if __name__ == "__main__":
    main()
