"""Chunked rendering, image evaluation and camera-path videos (reference
renderer.py:12-197), the JAX package's ``render_chunked``, ``evaluation``
and ``evaluation_path`` (``iffnerf_tpu/render/renderer.py:94,205,286``).

Every ray goes through ``render_rays`` densely: a ray that misses the AABB
has no valid sample and comes out as the background with its far depth,
which is what the JAX package's span-sorted chunks give it without
touching the field (that sorting sizes the TPU's compiled programs and is
not ported). A chunk holds as many rays as keep its samples within
``chunk_samples``: at lego's 300^3 grid a ray has about a thousand samples,
and a fixed 16 384-ray chunk would hold about 10 GB of appearance products
alone.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from iffnerf_tpu_torch.data.rays_np import ray_directions_Ks_np, rays_with_radii_np
from iffnerf_tpu_torch.device import as_tensor, resolve_device
from iffnerf_tpu_torch.models.field import AlphaMask, FieldConfig
from iffnerf_tpu_torch.models.render import render_rays
from iffnerf_tpu_torch.utils.metrics import mse2psnr, rgb_lpips, rgb_ssim

CHUNK_SAMPLES = 1 << 22  # samples a chunk of render_chunked


@torch.no_grad()
def render_chunked(config: FieldConfig, params, mask: AlphaMask | None,
                   rays, n_samples: int = -1, white_bg: bool = False,
                   ndc_ray: bool = False, chunk_samples: int = CHUNK_SAMPLES,
                   device=None):
    """rays [N, 6|7] (numpy or tensor) -> (rgb [N, 3], depth [N]) tensors
    on ``device`` (CUDA unless ``device="cpu"``), the counterpart of
    ``OctreeRender_trilinear_fast`` (reference renderer.py:12-25). A chunk
    takes as many rays as keep it within ``chunk_samples`` samples."""
    dev = resolve_device(device)
    rays = as_tensor(rays, dev, torch.float32)
    s = n_samples if n_samples > 0 else config.n_samples
    step = max(1, chunk_samples // max(s, 1))
    rgbs, depths = [], []
    for i in range(0, rays.shape[0], step):
        rgb, depth, *_ = render_rays(
            config, params, mask, rays[i:i + step], is_train=False,
            white_bg=white_bg, ndc_ray=ndc_ray, n_samples=n_samples)
        rgbs.append(rgb)
        depths.append(depth)
    if not rgbs:
        return (torch.zeros((0, 3), device=dev), torch.zeros((0,), device=dev))
    return torch.cat(rgbs), torch.cat(depths)


def _write_video(path: str, frames) -> None:
    """mp4 through imageio when its ffmpeg backend is there, else a GIF."""
    import imageio

    try:
        imageio.mimwrite(path, np.stack(frames), fps=30, quality=10)
    except (ValueError, ImportError):
        imageio.mimwrite(path[:-4] + ".gif", np.stack(frames), fps=15)


def visualize_depth_numpy(depth: np.ndarray, minmax=None):
    """Depth colour map for the image dumps (cv2 JET, as the reference's
    utils.visualize_depth_numpy)."""
    import cv2

    x = np.nan_to_num(depth)
    mi = np.min(x[x > 0]) if (x > 0).any() else 0.0
    ma = np.max(x)
    if minmax is not None:
        mi, ma = minmax
    x = (x - mi) / (ma - mi + 1e-8)
    x = (255 * np.clip(x, 0, 1)).astype(np.uint8)
    return cv2.applyColorMap(x, cv2.COLORMAP_JET), [mi, ma]


def evaluation(dataset, config: FieldConfig, params, mask: AlphaMask | None,
               save_path: str | None = None, N_vis: int = 5, prtx: str = "",
               n_samples: int = -1, white_bg: bool = False,
               ndc_ray: bool = False, compute_extra_metrics: bool = True,
               chunk_samples: int = CHUNK_SAMPLES, device=None,
               log: dict | None = None):
    """Held-out-view evaluation (reference renderer.py:28-140): renders
    every selected image of a stacked ``dataset`` on ``device`` and returns
    the list of per-image PSNRs; SSIM (and LPIPS, where the ``lpips``
    package is installed) with ``compute_extra_metrics``. Images, depth
    composites, a video and ``mean.txt`` are written only when
    ``save_path`` is given (imageio and cv2 are imported then). ``log``, a
    dict, receives the lists ``ssim`` and ``seconds`` (each image's render
    time up to a synchronize)."""
    psnrs, ssims, l_alex, l_vgg, times = [], [], [], [], []
    if save_path is not None:
        os.makedirs(save_path, exist_ok=True)
        os.makedirs(save_path + "/rgbd", exist_ok=True)
    dev = resolve_device(device)
    n_images = len(dataset.all_rays)
    interval = 1 if N_vis < 0 else max(n_images // max(N_vis, 1), 1)
    idxs = list(range(0, n_images, interval))
    w, h = dataset.img_wh
    frames = []
    t0 = time.perf_counter()
    for idx in idxs:
        t_img = time.perf_counter()
        rays = dataset.all_rays[idx].reshape(-1, dataset.all_rays.shape[-1])
        rgb, depth = render_chunked(
            config, params, mask, rays, n_samples=n_samples,
            white_bg=white_bg, ndc_ray=ndc_ray, chunk_samples=chunk_samples,
            device=dev)
        rgb = rgb.reshape(h, w, 3).cpu().numpy()
        depth = depth.reshape(h, w).cpu().numpy()
        times.append(time.perf_counter() - t_img)
        if len(dataset.all_rgbs):
            gt = dataset.all_rgbs[idx]
            gt = (gt.cpu().numpy() if isinstance(gt, torch.Tensor)
                  else np.asarray(gt)).reshape(h, w, -1)
            if gt.shape[-1] == 4:
                bg = 1.0 if white_bg else 0.0
                gt = gt[..., :3] * gt[..., -1:] + bg * (1.0 - gt[..., -1:])
            psnrs.append(mse2psnr(float(np.mean((rgb - gt) ** 2))))
            if compute_extra_metrics:
                ssims.append(rgb_ssim(rgb, gt, 1.0))
                try:
                    l_alex.append(rgb_lpips(gt, rgb, "alex"))
                    l_vgg.append(rgb_lpips(gt, rgb, "vgg"))
                except RuntimeError:
                    pass
        if save_path is not None:
            import imageio

            rgb8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
            depth8, _ = visualize_depth_numpy(depth, dataset.near_far)
            imageio.imwrite(f"{save_path}/{prtx}{idx:03d}.png", rgb8)
            imageio.imwrite(f"{save_path}/rgbd/{prtx}{idx:03d}.png",
                            np.concatenate([rgb8, depth8], axis=1))
            frames.append(rgb8)
    elapsed = time.perf_counter() - t0
    if save_path is not None and frames:
        _write_video(f"{save_path}/{prtx}video.mp4", frames)
    if psnrs and save_path is not None:
        with open(f"{save_path}/{prtx}mean.txt", "w") as f:
            f.write(f"PSNR: {np.mean(psnrs)}\n")
            if ssims:
                f.write(f"SSIM: {np.mean(ssims)}\n")
            if l_alex:
                f.write(f"LPIPS_alex: {np.mean(l_alex)}\n"
                        f"LPIPS_vgg: {np.mean(l_vgg)}\n")
            f.write(f"n_images: {len(idxs)} time_s: {elapsed}\n")
    if log is not None:
        log.update(ssim=ssims, seconds=times)
    return psnrs


def evaluation_path(config: FieldConfig, params, mask: AlphaMask | None,
                    c2ws, dataset, save_path: str | None = None,
                    prtx: str = "", n_samples: int = -1,
                    white_bg: bool = False, ndc_ray: bool = False,
                    chunk_samples: int = CHUNK_SAMPLES, device=None,
                    log: dict | None = None):
    """Renders a camera path c2ws [M, 4, 4] at ``dataset``'s ``img_wh`` and
    ``K`` (reference renderer.py:143-197) -> the frames, uint8 [H, W, 3]
    numpy arrays; a video when ``save_path`` is given. Each frame's rays
    are cast with mip radii (``rays_with_radii_np``) and rendered with
    ``ndc_ray`` as given, without an NDC warp: the JAX package's path
    render does so (``iffnerf_tpu/render/renderer.py:286-322``), where
    the LLFF loader warps its own rays. ``log``, a dict, receives the list
    ``seconds`` (each frame's render time up to a synchronize)."""
    dev = resolve_device(device)
    w, h = dataset.img_wh
    ori_dirs, dx, dy = ray_directions_Ks_np(h, w, np.asarray(dataset.K))
    ori_dirs, dx, dy = ori_dirs[0], dx[0], dy[0]
    dirs = ori_dirs / np.linalg.norm(ori_dirs, axis=-1, keepdims=True)

    frames, times = [], []
    if save_path is not None:
        os.makedirs(save_path, exist_ok=True)
    for c2w in np.asarray(c2ws):
        t0 = time.perf_counter()
        rays_o, rays_d, radii = rays_with_radii_np(
            dirs, c2w.astype(np.float32), directions=ori_dirs, dx=dx, dy=dy)
        rays = np.concatenate([rays_o.reshape(-1, 3), rays_d.reshape(-1, 3),
                               radii.reshape(-1, 1)], -1).astype(np.float32)
        rgb, _ = render_chunked(
            config, params, mask, rays, n_samples=n_samples,
            white_bg=white_bg, ndc_ray=ndc_ray, chunk_samples=chunk_samples,
            device=dev)
        rgb = rgb.reshape(h, w, 3).cpu().numpy()
        times.append(time.perf_counter() - t0)
        frames.append((np.clip(rgb, 0, 1) * 255).astype(np.uint8))
    if save_path is not None and frames:
        _write_video(f"{save_path}/{prtx}video.mp4", frames)
    if log is not None:
        log.update(seconds=times)
    return frames
