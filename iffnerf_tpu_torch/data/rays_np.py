"""Host-side (numpy) ray generation for the data layer
(reference ray_utils.py:28-100)."""

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
