"""Convergence of the iNeRF refinement on ``chip_smoke.py``'s synthetic
field, across the field's appearance contrast and the start.

For each appearance std, ``chip_smoke.make_inerf_field`` builds the
lego-width field with appearance factors of that std drawn on a coarse
grid; a frame is rendered from it (``render_rgba``) and
``estimate_pose_inerf`` refines, at ``test_pose_estimation``'s settings,
starts rotated about z and shifted off the true pose. Prints one JSON
line a run: the errors before, at a few iterations and after, the mean
rgb loss of the first and the last 50 iterations, the colour contrast
inside the object, and the frame's ms.

    python3 iffnerf_tpu_torch/tools/inerf_sweep.py --app_std 1 3

Run it from a checkout's root on a card (``--device cpu`` with a small
``--grid``, ``--wh`` and ``--batch`` rehearses it on the CPU).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np


def main(argv=None) -> None:
    sys.path.insert(0, ".")   # the checkout in the working directory
    import chip_smoke as cs
    from iffnerf_tpu_torch.device import resolve_device
    from iffnerf_tpu_torch.inerf.estimate import estimate_pose_inerf

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--app_std", type=float, nargs="+",
                    default=[cs.INERF_APP_STD])
    ap.add_argument("--coarse", type=int, default=cs.INERF_COARSE)
    ap.add_argument("--starts", type=float, nargs="+",
                    default=[cs.INERF_ROT_DEG],
                    help="degrees about z; the shift scales with them "
                         "(+0.15 at 12 degrees, as the JAX test)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[cs.SEED])
    ap.add_argument("--iters", type=int, default=cs.INERF_ITERS)
    ap.add_argument("--batch", type=int, default=cs.INERF_BATCH)
    ap.add_argument("--grid", type=int, default=cs.GRID)
    ap.add_argument("--wh", type=int, default=cs.FT_WH)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cs.GRID, cs.FT_WH, cs.INERF_COARSE = args.grid, args.wh, args.coarse
    if dev.type == "cuda":
        print(cs.card_line(), flush=True)
    cam_k = cs.lego_camera()
    gt = cs._look_at_c2w(4.0 * np.array([math.cos(0.6) * math.cos(0.5),
                                         math.sin(0.6) * math.cos(0.5),
                                         math.sin(0.5)]))
    for std in args.app_std:
        cs.INERF_APP_STD = std
        config, params, mask = cs.make_inerf_field(dev)
        obs = cs.render_rgba(config, params, mask, gt, cam_k, dev)
        inside = obs[..., 3] > 0.5
        contrast = float(obs[..., :3][inside].std())
        for deg in args.starts:
            cs.INERF_ROT_DEG = deg
            cs.INERF_SHIFT = 0.15 * deg / 12.0
            start = cs.perturbed(gt)
            for seed in args.seeds:
                t0 = time.perf_counter()
                with cs.kept_refine() as kept:
                    _, pose, hist = estimate_pose_inerf(
                        start, obs, cam_k, config, params, mask,
                        sampling_strategy="random", lrate=cs.INERF_LRATE,
                        batch_size=args.batch, color_bkgd_aug="random",
                        n_iters=args.iters, dice_loss=True, seed=seed,
                        return_history=True, device=dev)
                ms = (time.perf_counter() - t0) * 1e3
                losses = kept["out"][0].cpu().numpy()
                marks = [k for k in (0, 50, 100, 200, 400) if k < args.iters]
                print(json.dumps({
                    "app_std": std, "coarse": args.coarse,
                    "contrast": contrast, "start_deg": deg, "seed": seed,
                    "frame_ms": ms, "errors_before": cs.pose_errors(gt, start),
                    "errors_at": {k: cs.pose_errors(gt, hist[k])
                                  for k in marks},
                    "errors_after": cs.pose_errors(gt, pose),
                    "loss_first_last_50": [float(losses[:50].mean()),
                                           float(losses[-50:].mean())],
                    "device": str(dev)}), flush=True)


if __name__ == "__main__":
    main()
