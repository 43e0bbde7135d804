"""PSNR and SSIM (and LPIPS where the ``lpips`` package and its weights
are installed) over saved image pairs: the JAX package's
``extra/compute_metrics.py`` over the port's ``utils/metrics.py``.

    python -m iffnerf_tpu_torch.tools.compute_metrics <renders_dir> <gt_dir>

Files are paired in sorted order; the images must be PNG or JPG of one
size.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from iffnerf_tpu_torch.utils.metrics import mse2psnr, rgb_lpips, rgb_ssim


def load_dir(path: str):
    from PIL import Image

    files = sorted(
        f for f in os.listdir(path)
        if f.lower().endswith((".png", ".jpg", ".jpeg"))
    )
    return [
        np.asarray(Image.open(os.path.join(path, f)).convert("RGB"),
                   dtype=np.float32) / 255.0
        for f in files
    ]


def main(render_dir: str, gt_dir: str) -> dict:
    """Prints the means -> {"psnr", "ssim"[, "lpips_alex"]}."""
    renders = load_dir(render_dir)
    gts = load_dir(gt_dir)
    assert len(renders) == len(gts), "directory image counts differ"

    psnrs, ssims, lpips_a = [], [], []
    for r, g in zip(renders, gts):
        psnrs.append(mse2psnr(float(np.mean((r - g) ** 2))))
        ssims.append(rgb_ssim(r, g, 1.0))
        try:
            lpips_a.append(rgb_lpips(g, r, "alex"))
        except RuntimeError:
            pass
    out = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims))}
    print(f"PSNR: {out['psnr']:.3f}")
    print(f"SSIM: {out['ssim']:.4f}")
    if lpips_a:
        out["lpips_alex"] = float(np.mean(lpips_a))
        print(f"LPIPS(alex): {out['lpips_alex']:.4f}")
    return out


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
