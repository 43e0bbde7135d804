#!/usr/bin/env python
"""How the colour-histogram similarity of train and test views relates to
camera distance: the JAX package's ``tools/histogram_correlation.py`` over
the port's ``load_blender`` (a working replacement for the reference's
tools/display_histogram_correlation.py:20-100, which imports a
``build_hist`` from a module that does not exist).

For every (train, test) image pair: a 255-bin density histogram of each
image over all its channels, their similarity under ``--comparison``
(pearson, spearman, chi_squared, L2 or kl_divergence), and the Euclidean
distance of the camera centres. Writes a CSV of the pairs and, where
matplotlib imports, the reference's scatter plot as a PNG.

    python -m iffnerf_tpu_torch.tools.histogram_correlation <object dir> \\
        [--comparison chi_squared] [--out_csv hist_correlation.csv]
"""

from __future__ import annotations

import argparse
import csv

import numpy as np


def build_hist(images: np.ndarray, n_bins: int = 255) -> np.ndarray:
    """[N, H*W, C] (or [N, H, W, C]) float images -> [N, n_bins] density
    histograms over all channels."""
    flat = images.reshape(images.shape[0], -1)
    top = max(float(flat.max()), 1e-8)
    edges = np.linspace(0.0, top, n_bins + 1)
    return np.stack(
        [np.histogram(img, bins=edges, density=True)[0] for img in flat]
    )


def _rankdata(x: np.ndarray) -> np.ndarray:
    """Average-tie ranks along the last axis (for Spearman)."""
    order = np.argsort(x, axis=-1)
    ranks = np.empty_like(order, dtype=np.float64)
    np.put_along_axis(
        ranks, order,
        np.broadcast_to(np.arange(x.shape[-1], dtype=np.float64), x.shape),
        axis=-1,
    )
    out = np.empty_like(ranks)
    for i, row in enumerate(x):
        _, inv, counts = np.unique(row, return_inverse=True,
                                   return_counts=True)
        sums = np.zeros(counts.shape[0])
        np.add.at(sums, inv, ranks[i])
        out[i] = sums[inv] / counts[inv]
    return out


def _pearson_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = a - a.mean(-1, keepdims=True)
    b = b - b.mean(-1, keepdims=True)
    denom = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
    return np.einsum("ij,ij->i", a, b) / np.maximum(denom, 1e-12)


def pairwise_coefficients(train_hists: np.ndarray, test_hists: np.ndarray,
                          comparison: str) -> np.ndarray:
    """[N_train, bins] x [N_test, bins] -> [N_train, N_test] coefficients
    (the reference tool's metrics)."""
    n_tr, n_te = train_hists.shape[0], test_hists.shape[0]
    ti, si = np.meshgrid(np.arange(n_tr), np.arange(n_te), indexing="ij")
    a = train_hists[ti.ravel()]
    b = test_hists[si.ravel()]
    if comparison == "pearson":
        coef = _pearson_rows(a, b)
    elif comparison == "spearman":
        coef = _pearson_rows(_rankdata(a), _rankdata(b))
    elif comparison == "chi_squared":
        coef = 0.5 * np.sum(np.square(a - b) / np.maximum(a + b, 1e-12), -1)
    elif comparison == "L2":
        coef = np.sqrt(np.sum(np.square(a - b), -1))
    elif comparison == "kl_divergence":
        coef = np.sum(
            np.where(b > 0, b * (np.log(np.maximum(b, 1e-12))
                                 - np.log(np.maximum(a, 1e-12))), 0.0), -1)
    else:
        raise ValueError(f"Unknown comparison method: {comparison}")
    return coef.reshape(n_tr, n_te)


def compute_correlation(datadir: str, comparison: str = "chi_squared",
                        out_csv: str = "hist_correlation.csv",
                        out_png: str | None = None,
                        downsample: float = 1.0):
    """-> (distances, coefficients), both [N_train, N_test]."""
    from iffnerf_tpu_torch.data import load_blender

    train = load_blender(datadir, split="train", downsample=downsample,
                         is_stack=True)
    test = load_blender(datadir, split="test", downsample=downsample,
                        is_stack=True)
    train_hists = build_hist(np.asarray(train.all_rgbs))
    test_hists = build_hist(np.asarray(test.all_rgbs))

    # camera centres are the translation column of the c2w poses
    tr_pos = np.asarray(train.poses)[:, :3, 3]
    te_pos = np.asarray(test.poses)[:, :3, 3]
    distances = np.linalg.norm(tr_pos[:, None] - te_pos[None], axis=-1)

    coef = pairwise_coefficients(train_hists, test_hists, comparison)

    with open(out_csv, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["train_idx", "test_idx", "distance", comparison])
        for i in range(coef.shape[0]):
            for j in range(coef.shape[1]):
                writer.writerow([i, j, distances[i, j], coef[i, j]])
    print(f"wrote {coef.size} pairs -> {out_csv}")

    if out_png:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("matplotlib not available; skipping plot")
            return distances, coef
        plt.scatter(distances.ravel(), coef.ravel(), s=4)
        plt.suptitle(f"Correlation results using the {comparison} metric")
        plt.xlabel("Geodetic distance")
        plt.ylabel("Correlation")
        if comparison in ("spearman", "pearson"):
            plt.ylim([0.5, 1.0])
        plt.savefig(out_png, dpi=120)
        print(f"wrote {out_png}")
    return distances, coef


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("datadir", help="NeRF-synthetic object dir")
    ap.add_argument("--comparison", default="chi_squared",
                    choices=["pearson", "spearman", "chi_squared", "L2",
                             "kl_divergence"])
    ap.add_argument("--out_csv", default="hist_correlation.csv")
    ap.add_argument("--out_png", default=None)
    ap.add_argument("--downsample", type=float, default=1.0)
    a = ap.parse_args(argv)
    return compute_correlation(a.datadir, a.comparison, a.out_csv, a.out_png,
                               a.downsample)


if __name__ == "__main__":
    main()
