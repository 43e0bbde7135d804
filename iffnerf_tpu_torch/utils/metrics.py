"""Image quality metrics (reference utils.py:10,42-114), as the JAX package
computes them (``iffnerf_tpu/utils/metrics.py``).

SSIM follows the mip-NeRF formulation the reference vendors
(utils.py:61-114): a separable Gaussian blur in valid mode and clipped
variances. Host numpy: eval images are small.
"""

from __future__ import annotations

import numpy as np


def mse2psnr(mse: float) -> float:
    """(reference utils.py:10)"""
    return float(-10.0 * np.log(mse) / np.log(10.0))


def _blur_valid(z: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """Separable valid-mode convolution of [H, W, C] with ``filt`` along
    H, then W (``jax.scipy.signal.convolve2d`` twice; the filter is
    symmetric, so convolution and correlation agree)."""
    k = filt.shape[0]
    h, w = z.shape[:2]
    rows = sum(filt[i] * z[i:h - k + 1 + i] for i in range(k))
    return sum(filt[i] * rows[:, i:w - k + 1 + i] for i in range(k))


def rgb_ssim(img0, img1, max_val: float = 1.0, filter_size: int = 11,
             filter_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03,
             return_map: bool = False):
    """SSIM of two [H, W, 3] images (reference utils.py:61-114)."""
    img0 = np.asarray(img0, dtype=np.float32)
    img1 = np.asarray(img1, dtype=np.float32)
    if img0.ndim != 3 or img0.shape[-1] != 3 or img0.shape != img1.shape:
        raise ValueError(f"rgb_ssim takes two [H, W, 3] images, got "
                         f"{img0.shape} and {img1.shape}")
    hw = filter_size // 2
    shift = (2 * hw - filter_size + 1) / 2
    f_i = ((np.arange(filter_size) - hw + shift) / filter_sigma) ** 2
    filt = np.exp(-0.5 * f_i)
    filt = (filt / filt.sum()).astype(np.float32)

    def blur(z):
        return _blur_valid(z, filt)

    mu0, mu1 = blur(img0), blur(img1)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    sigma00 = np.maximum(0.0, blur(img0 ** 2) - mu00)
    sigma11 = np.maximum(0.0, blur(img1 ** 2) - mu11)
    sigma01 = blur(img0 * img1) - mu01
    sigma01 = np.sign(sigma01) * np.minimum(np.sqrt(sigma00 * sigma11),
                                            np.abs(sigma01))
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    ssim_map = ((2 * mu01 + c1) * (2 * sigma01 + c2)) / (
        (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2))
    if return_map:
        return ssim_map
    return float(np.mean(ssim_map))


def rgb_lpips(np_gt: np.ndarray, np_im: np.ndarray, net_name: str = "alex",
              device: str = "cpu") -> float:
    """LPIPS through the optional ``lpips`` package (reference
    utils.py:33-48). Raises RuntimeError when the package or its weights
    are missing, as the JAX package's does; nothing is downloaded."""
    try:
        import lpips
    except ImportError as e:
        raise RuntimeError(
            "LPIPS requires the `lpips` package (and its pretrained "
            "weights); not available in this environment") from e
    if not hasattr(lpips, "LPIPS"):
        raise RuntimeError("`lpips` module present but unusable (no LPIPS)")
    import torch

    net = lpips.LPIPS(net=net_name, version="0.1").eval().to(device)
    gt = torch.from_numpy(np_gt).permute(2, 0, 1).contiguous().to(device)
    im = torch.from_numpy(np_im).permute(2, 0, 1).contiguous().to(device)
    return float(net(gt, im, normalize=True).item())
