"""One-command pose-accuracy gate of the port: the JAX package's
``tools/run_accuracy_gate.py`` over the port's own pieces.

  1. DINOv2 ViT-S/14 conversion (``python -m
     iffnerf_tpu_torch.tools.convert_dinov2``), skipped when ``--dinov2``
     is already a converted ``.npz``;
  2. ID-module training and pose evaluation (``python -m
     iffnerf_tpu_torch.pose_cli`` with ``--backbone_ckpt``, on the CUDA
     card unless ``--device cpu``), the reference's pose flow
     (train_eval_pose_est.py:24-154);
  3. aggregation (``evaluate_poses``: the schema of the JAX package's
     ``tools/compute_eval_statistics.py:38-112``, copied here);
  4. threshold checks on the aggregate medians (``apply_gate``).

    python -m iffnerf_tpu_torch.tools.run_accuracy_gate \\
        --dinov2 dinov2_vits14.pth \\
        --config configs/lego.txt --datadir data/nerf_synthetic \\
        --exp_patch log --out_dir gate

The JAX gate's HuggingFace route (``--dinov2`` naming a model id, which
needs ``transformers``) is not ported: a ``--dinov2`` that is neither an
existing torch checkpoint nor an ``.npz`` is a pipeline error. The
default bounds (30 degrees, 0.5 units) are the JAX gate's loose sanity
bounds; set ``--max_median_rot_deg`` and ``--max_median_trans`` from the
paper's table (arXiv:2403.12682, Tab. I/II) for the scene under test.

Exit code 0 = gate passed; 1 = threshold violated; 2 = pipeline error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from math import sqrt

import numpy as np

# the checkout's root, on the child processes' path
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

REQUIRED_ROW_FIELDS = (
    "sequence_id", "category_name", "frame_id", "loss", "scores_loss",
    "recall", "total_optimization_time_in_ms", "pred_c2w", "gt_c2w",
)
REQUIRED_STAT_FIELDS = (
    "n", "mean_angular_error", "median_angular_error",
    "mean_translation_error", "median_translation_error",
    "ang_acc@5.", "tr_acc@.1", "mean_inference_time_s",
)
ANGULAR_LEVELS = ("2.5", "5.", "10.", "30.")
TRANSLATION_LEVELS = (".1", ".2", ".5")


def _run_module(module: str, args: list) -> None:
    """``python -m <module> <args>`` with the checkout on its path; raises
    CalledProcessError on a non-zero exit."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    subprocess.run([sys.executable, "-m", module, *args], check=True,
                   env=env)


def convert_weights(dinov2: str, out_dir: str) -> str:
    """Step 1: the converted npz (an existing npz is taken as it is)."""
    if dinov2.endswith(".npz"):
        if not os.path.exists(dinov2):
            raise FileNotFoundError(dinov2)
        return dinov2
    if not os.path.isfile(dinov2):
        raise RuntimeError(
            f"--dinov2 {dinov2!r} names neither a torch checkpoint nor an "
            ".npz (the HuggingFace route needs transformers and is not "
            "ported)")
    out = os.path.join(out_dir, "dinov2_vits14.npz")
    _run_module("iffnerf_tpu_torch.tools.convert_dinov2",
                ["--torch_ckpt", dinov2, "--out", out])
    return out


def run_pose_pipeline(args, backbone_ckpt: str | None) -> str:
    """Step 2: the port's pose CLI -> the path of its JSON rows."""
    out_json = os.path.join(args.out_dir, "pose_results.json")
    cmd = [
        "--config", args.config,
        "--datadir", args.datadir,
        "--exp_patch", args.exp_patch,
        "--out_path", out_json,
        "--id_iters", str(args.id_iters),
        "--accum_steps", str(args.accum_steps),
        "--gen_points", str(args.gen_points),
    ]
    if backbone_ckpt:
        cmd += ["--backbone_ckpt", backbone_ckpt]
    else:
        cmd += ["--id_backbone_depth", str(args.id_backbone_depth)]
    if args.device:
        cmd += ["--device", args.device]
    if args.extra_args:
        cmd += args.extra_args
    _run_module("iffnerf_tpu_torch.pose_cli", cmd)
    return out_json


def compute_angular_error(rotation_gt, rotation_est):
    cos_angle = (np.trace(rotation_gt @ np.linalg.inv(rotation_est)) - 1) / 2
    return np.degrees(np.arccos(np.clip(cos_angle, -1, 1)))


def compute_confidence_interval(n, mean, std, confidence: float = 0.95):
    from scipy.stats import t

    t_crit = abs(t.ppf((1 - confidence) / 2, n - 1))
    half = std * t_crit / sqrt(n)
    return mean - half, mean + half


def evaluate_poses(filepath: str) -> dict:
    """Angular and translation errors of a pose-JSON file's rows, their
    means, spreads, medians and 95 % intervals, the accuracies at the
    reference's thresholds and the mean inference time (reference
    tools/compute_eval_statistics.py:33-176)."""
    with open(filepath) as fh:
        results = json.load(fh)

    angular_errors, translation_errors = [], []
    inference_times, photometric_errors = [], []
    ang_hits = {lv: [] for lv in ANGULAR_LEVELS}
    tr_hits = {lv: [] for lv in TRANSLATION_LEVELS}

    for result in results:
        gt_c2w = np.asarray(result["gt_c2w"])
        pred_c2w = np.asarray(result["pred_c2w"])
        ang = compute_angular_error(
            np.linalg.inv(gt_c2w)[:3, :3], np.linalg.inv(pred_c2w)[:3, :3]
        )
        tr = float(np.linalg.norm(gt_c2w[:3, 3] - pred_c2w[:3, 3]))
        angular_errors.append(float(ang))
        translation_errors.append(tr)
        for lv in ANGULAR_LEVELS:
            if ang < float(lv):
                ang_hits[lv].append(ang)
        for lv in TRANSLATION_LEVELS:
            if tr < float(lv):
                tr_hits[lv].append(tr)
        inference_times.append(result["total_optimization_time_in_ms"])
        photometric_errors.append(result["loss"])

    n = len(results)
    stats = {
        "n": n,
        "mean_angular_error": float(np.mean(angular_errors)),
        "std_angular_error": float(np.std(angular_errors, ddof=1)),
        "mean_translation_error": float(np.mean(translation_errors)),
        "std_translation_error": float(np.std(translation_errors, ddof=1)),
        "median_angular_error": float(np.median(angular_errors)),
        "median_translation_error": float(np.median(translation_errors)),
        "mean_inference_time_s": float(np.mean(inference_times)) / 1000.0,
        "mean_photometric_error": float(np.mean(photometric_errors)),
    }
    stats["angular_ci95"] = compute_confidence_interval(
        n, stats["mean_angular_error"], stats["std_angular_error"]
    )
    stats["translation_ci95"] = compute_confidence_interval(
        n, stats["mean_translation_error"], stats["std_translation_error"]
    )
    for lv in ANGULAR_LEVELS:
        stats[f"ang_acc@{lv}"] = 100.0 * len(ang_hits[lv]) / n
        stats[f"ang_err@{lv}"] = (
            float(np.mean(ang_hits[lv])) if ang_hits[lv] else float("nan")
        )
    for lv in TRANSLATION_LEVELS:
        stats[f"tr_acc@{lv}"] = 100.0 * len(tr_hits[lv]) / n
        stats[f"tr_err@{lv}"] = (
            float(np.mean(tr_hits[lv])) if tr_hits[lv] else float("nan")
        )
    return stats


def aggregate(out_json: str, out_dir: str) -> dict:
    """Step 3: the aggregate and its schema checks; writes
    ``gate_stats.json``."""
    with open(out_json) as fh:
        rows = json.load(fh)
    if not rows:
        raise RuntimeError(
            f"{out_json} holds no result rows — check the exp dir naming "
            "(tensorf_<obj>_VM) and --limit_categories"
        )
    for field in REQUIRED_ROW_FIELDS:
        if field not in rows[0]:
            raise RuntimeError(f"result rows missing field {field!r}")
    stats = evaluate_poses(out_json)
    for field in REQUIRED_STAT_FIELDS:
        if field not in stats:
            raise RuntimeError(f"aggregate stats missing field {field!r}")
    with open(os.path.join(out_dir, "gate_stats.json"), "w") as fh:
        json.dump(stats, fh, indent=2, default=list)
    return stats


def apply_gate(stats: dict, args) -> bool:
    checks = {
        "median_angular_error": (stats["median_angular_error"],
                                 args.max_median_rot_deg),
        "median_translation_error": (stats["median_translation_error"],
                                     args.max_median_trans),
    }
    if args.min_acc5 is not None:
        checks["ang_acc@5."] = (-stats["ang_acc@5."], -args.min_acc5)
    ok = True
    for name, (value, bound) in checks.items():
        passed = value <= bound
        ok = ok and passed
        print(f"gate {name}: {abs(value):.4g} "
              f"{'<=' if passed else '>'} {abs(bound):.4g} "
              f"[{'OK' if passed else 'FAIL'}]")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="convert -> train ID module -> evaluate -> assert")
    ap.add_argument("--dinov2", default=None,
                    help="torch checkpoint or converted npz of DINOv2 "
                         "ViT-S/14; omit (with --allow_random_init) for a "
                         "plumbing-only run")
    ap.add_argument("--allow_random_init", action="store_true",
                    help="run without pretrained weights (pipeline smoke "
                         "only: novel-view accuracy needs DINOv2)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--datadir", required=True)
    ap.add_argument("--exp_patch", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--id_iters", type=int, default=1500)
    ap.add_argument("--accum_steps", type=int, default=32)
    ap.add_argument("--gen_points", type=int, default=20000)
    ap.add_argument("--id_backbone_depth", type=int, default=12)
    ap.add_argument("--max_median_rot_deg", type=float, default=30.0)
    ap.add_argument("--max_median_trans", type=float, default=0.5)
    ap.add_argument("--min_acc5", type=float, default=None,
                    help="optional minimum ang_acc@5deg percentage")
    ap.add_argument("--device", type=str, default=None,
                    help="the pose CLI's torch device (default: the CUDA "
                         "card)")
    ap.add_argument("extra_args", nargs="*",
                    help="passed through to the pose CLI")
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    try:
        if args.dinov2 is None:
            if not args.allow_random_init:
                ap.error("--dinov2 is required (or pass "
                         "--allow_random_init for a plumbing smoke run)")
            backbone = None
        else:
            backbone = convert_weights(args.dinov2, args.out_dir)
        out_json = run_pose_pipeline(args, backbone)
        stats = aggregate(out_json, args.out_dir)
    except (subprocess.CalledProcessError, RuntimeError, OSError) as e:
        print(f"accuracy gate pipeline error: {e}", file=sys.stderr)
        return 2
    ok = apply_gate(stats, args)
    print(json.dumps({
        "gate": "pose_accuracy",
        "passed": bool(ok),
        "median_angular_error_deg": stats["median_angular_error"],
        "median_translation_error": stats["median_translation_error"],
        "n_images": stats["n"],
        "pretrained_backbone": args.dinov2 is not None,
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
