"""Host-side (numpy) ray generation for the data layer (reference
ray_utils.py:28-100, dataLoader/ray_utils.py:29-123): the Blender and
Tanks-and-Temples rays with mip radii, and the focal-based rays and the NDC
warp of the LLFF, NSVF and your-own loaders."""

from __future__ import annotations

import math

import numpy as np


def ray_directions_Ks_np(H: int, W: int, K: np.ndarray,
                         use_pixel_centers: bool = True):
    """K [B, 3, 3] -> (directions, dx, dy) each [B, H, W, 3]
    (reference ray_utils.py:28-58)."""
    pc = 0.5 if use_pixel_centers else 0.0
    i, j = np.meshgrid(
        np.arange(W, dtype=np.float32) + pc,
        np.arange(H, dtype=np.float32) + pc,
        indexing="xy",
    )
    base = np.stack([i, j], axis=-1)
    base_dx = base.copy()
    base_dx[..., 0] += 1
    base_dy = base.copy()
    base_dy[..., 1] += 1
    stacked = np.stack([base, base_dx, base_dy])  # [3, H, W, 2]
    coords = np.concatenate([stacked, np.ones_like(stacked[..., :1])], -1)
    inv_k = np.linalg.inv(np.asarray(K, dtype=np.float32))
    dirs = np.einsum("bij,ghwj->bghwi", inv_k, coords)
    return dirs[:, 0], dirs[:, 1], dirs[:, 2]


def rays_with_radii_np(viewdirs, c2w, directions=None, dx=None, dy=None,
                       keepdim: bool = True):
    """World rays + mip radii (reference ray_utils.py:61-100)."""
    rot = c2w[..., :3, :3]
    rays_d = np.sum(viewdirs[..., None, :] * rot, axis=-1)
    dx_w = np.sum(dx[..., None, :] * rot, axis=-1)
    dy_w = np.sum(dy[..., None, :] * rot, axis=-1)
    dirs_w = (
        np.sum(directions[..., None, :] * rot, axis=-1)
        if directions is not None
        else rays_d
    )
    rays_o = np.broadcast_to(c2w[..., :3, 3], rays_d.shape).copy()

    if not keepdim:
        rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
        dirs_w, dx_w, dy_w = (
            dirs_w.reshape(-1, 3), dx_w.reshape(-1, 3), dy_w.reshape(-1, 3),
        )
    dx_norm = np.linalg.norm(dx_w - dirs_w, axis=-1)
    dy_norm = np.linalg.norm(dy_w - dirs_w, axis=-1)
    radii = (0.5 * (dx_norm + dy_norm))[..., None] * (2.0 / math.sqrt(12.0))
    return rays_o, rays_d, radii


def ray_directions_np(H: int, W: int, focal, center=None, blender: bool = True):
    """Focal-based camera dirs (dataLoader/ray_utils.py:29-71)."""
    i, j = np.meshgrid(
        np.arange(W, dtype=np.float32) + 0.5,
        np.arange(H, dtype=np.float32) + 0.5,
        indexing="xy",
    )
    cx, cy = center if center is not None else (W / 2, H / 2)
    sign = -1.0 if blender else 1.0
    return np.stack(
        [(i - cx) / focal[0], sign * (j - cy) / focal[1],
         sign * np.ones_like(i)],
        axis=-1,
    )


def rays_simple_np(directions, c2w):
    """(dataLoader/ray_utils.py:74-95)"""
    rays_d = directions @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
    return rays_o.reshape(-1, 3).copy(), rays_d.reshape(-1, 3)


def ndc_rays_blender_np(H, W, focal, near, rays_o, rays_d):
    """(dataLoader/ray_utils.py:98-123)"""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (W / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2]
    )
    d1 = -1.0 / (H / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2]
    )
    d2 = -2.0 * near / rays_o[..., 2]
    return np.stack([o0, o1, o2], -1), np.stack([d0, d1, d2], -1)
