"""Times the two callers of the softmax over rays on one card, for one or
more checkouts in turns: the ID-module optimizer step
(``pose/trainer.id_train_step``) at ``chip_smoke.py``'s ``id_train`` width
(DINOv2 ViT-S/14 depth 12 in float32, 540 000 candidate rays, 32 images of
800x800 a step) and the exact route's scoring (``pose/id_module.
score_rays`` in bfloat16 against precomputed keys, one image's queries:
the logits, the softmax and the column sums).

    python3 -m iffnerf_tpu_torch.tools.softmax_time <label> [--roots A,B,...] [--steps N]

Each entry of ``--roots`` (default ``.``) is a checkout's root, whose
package is imported from there in a process of its own, one after the
other: ``--roots build/parent,.,.,build/parent`` runs a parent commit
unpacked beside the change, the change twice, and the parent again.
Parameters, rays and frames come from a seed, alike in every checkout.
Prints one JSON line: the label, the card's name and power limit, and for
each run its root, the host seconds of each of ``--steps`` steps after a
warm-up (up to a synchronize) and their median, the CUDA-event ms of one
more step's parts (``id_train_step``'s marks) and the median CUDA-event ms
of ``score_rays`` over 20 calls.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

N_RAYS, N_IMAGES, SIDE, SEED = 540_000, 32, 800, 0
SCORE_REPS = 20


def _inputs(torch, dev):
    """Rays [N_RAYS, 3] x 3, 32 RGBA frames with an elliptic alpha mask and
    poses on a sphere of radius 4, from the seed."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    ro = torch.rand((N_RAYS, 3), generator=g, device=dev) * 2 - 1
    rd = torch.randn((N_RAYS, 3), generator=g, device=dev)
    rd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    rr = torch.rand((N_RAYS, 3), generator=g, device=dev)
    rgb = torch.rand((N_IMAGES, SIDE, SIDE, 3), generator=g, device=dev)
    yy = torch.arange(SIDE, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(SIDE, device=dev, dtype=torch.float32)[None, :]
    alpha = (((yy - SIDE / 2) / (SIDE / 4)) ** 2
             + ((xx - SIDE / 2) / (SIDE / 3)) ** 2 < 1.0).float()
    frames = torch.cat([rgb, alpha[None, ..., None].expand(
        N_IMAGES, SIDE, SIDE, 1)], dim=-1)
    poses = torch.eye(4, device=dev).repeat(N_IMAGES, 1, 1)
    t = torch.linspace(0, 2 * math.pi, N_IMAGES + 1, device=dev)[:-1]
    poses[:, :3, 3] = 4.0 * torch.stack(
        [t.cos() * math.cos(0.5), t.sin() * math.cos(0.5),
         torch.full_like(t, math.sin(0.5))], dim=-1)
    return (ro, rd, rr), frames, poses


def run_one(root: str, steps: int) -> dict:
    """Imports the package of the checkout at ``root`` and times it."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    import iffnerf_tpu_torch
    from iffnerf_tpu_torch.device import resolve_device, trainable
    from iffnerf_tpu_torch.pose.id_module import (
        IDConfig, image_queries, init_id_module, ray_bank, score_rays)
    from iffnerf_tpu_torch.pose.trainer import (
        blend_batch, id_train_step, make_id_optimizer)

    package = Path(iffnerf_tpu_torch.__file__).resolve().parent
    assert package.parent == Path(root).resolve(), package
    dev = resolve_device("cuda")
    (ro, rd, rr), frames, poses = _inputs(torch, dev)
    imgs, masks = blend_batch(frames)
    cfg = IDConfig()
    params = trainable(init_id_module(torch.Generator().manual_seed(SEED),
                                      cfg, device=dev), dev)
    opt = make_id_optimizer(params)

    def step(mark=None):
        return id_train_step(params, opt, imgs, masks, poses, ro, rd, rr, cfg,
                             N_IMAGES, mark=mark)

    step_s, losses = [], []
    for _ in range(1 + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step()))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    events = [("start", torch.cuda.Event(enable_timing=True))]
    events[0][1].record()

    def mark(label):
        events.append((label, torch.cuda.Event(enable_timing=True)))
        events[-1][1].record()

    step(mark)
    torch.cuda.synchronize()
    split = {f"{label}_ms": a.elapsed_time(b)
             for (_, a), (label, b) in zip(events, events[1:])}
    del params, opt

    cfg16 = IDConfig(compute_dtype="bfloat16", fused_bank=False)
    with torch.no_grad():
        p16 = init_id_module(torch.Generator().manual_seed(SEED), cfg16,
                             device=dev)
        bank = ray_bank(p16, cfg16, ro, rd, rr, device=dev)
        q, valid, _ = image_queries(p16, cfg16, imgs[0], masks[0])
        scores, _ = score_rays(p16, cfg16, q, valid, ro, rd, rr, bank=bank)
        score_ms = []
        for _ in range(SCORE_REPS):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            score_rays(p16, cfg16, q, valid, ro, rd, rr, bank=bank)
            b.record()
            torch.cuda.synchronize()
            score_ms.append(a.elapsed_time(b))
    return {"root": root, "warmup_step_s": step_s[0], "step_s": step_s[1:],
            "step_s_median": statistics.median(step_s[1:]),
            "losses": losses, "split": split,
            "score_rays_ms": statistics.median(score_ms),
            "score_rays_ms_range": [min(score_ms), max(score_ms)],
            "scores_sum": float(scores.sum())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("label")
    ap.add_argument("--roots", default=".")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(run_one(args.one, args.steps)))
        return 0
    from iffnerf_tpu_torch.device import card_line

    runs = []
    for root in args.roots.split(","):
        out = subprocess.run(
            [sys.executable, "-P", str(Path(__file__).resolve()), args.label,
             "--one", root, "--steps", str(args.steps)],
            capture_output=True, text=True, check=False)
        if out.returncode != 0:
            sys.stderr.write(out.stderr)
            print(f"softmax_time: the run of {root} exited "
                  f"{out.returncode}", file=sys.stderr)
            return 1
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    print(json.dumps({"label": args.label, "card": card_line(),
                      "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
