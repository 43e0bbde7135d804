"""Isocell equal-solid-angle hemisphere sampling + Rodrigues alignment
(reference pose_estimation/isocell.py:6-68,131-171).

The direction set is static per configuration (host numpy); the per-point
rotation is batched torch.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def isocell_distribution(ray_target: int, N0: int = 3,
                         isrand: int = -1, rng=None) -> np.ndarray:
    """Equal-area cells on the unit hemisphere -> [Ntot, 3] unit directions,
    Ntot = N0 * ceil(sqrt(ray_target/N0))^2 (reference isocell.py:6-68)."""
    n = int(math.ceil(math.sqrt(ray_target / N0)))
    ntot = int(N0 * n ** 2)
    dr = 1.0 / n

    rings_id = np.arange(1, n + 1, dtype=np.int64)
    nc = N0 * (2 * rings_id - 1)  # cells per ring
    R = np.repeat(rings_id, nc).astype(np.float64) * dr

    dth = 2.0 * math.pi / nc.astype(np.float64)
    cell_ids = np.arange(ntot, dtype=np.int64)
    nc_shift = np.concatenate([[0], np.cumsum(nc)[:-1]])
    ring_cell_ids = (cell_ids - np.repeat(nc_shift, nc)).astype(np.float64)
    dth_expanded = dth[np.repeat(np.arange(n), nc)]

    if rng is None:
        rng = np.random.default_rng(0)
    th0 = (0.0 if isrand == -1
           else float(rng.random()) * dth_expanded)
    th0 = th0 + ring_cell_ids * dth_expanded

    if isrand == 1:
        R = R - rng.random(ntot) * dr
        th = th0 + rng.random(ntot) * dth_expanded
    elif isrand == 2:
        R = R - rng.random(ntot) * dr
        th = th0 + dth_expanded / 2
    elif isrand == 3:
        R = R - (1 + rng.standard_normal(ntot) / 6.5) / 2 * dr
        th = th0 + (1 + rng.standard_normal(ntot) / 6.5) / 2 * dth_expanded / 2
    elif isrand == 4:
        R = R - (1 + rng.standard_normal(ntot) / 6.5) / 2 * dr
        th = th0 + dth_expanded / 2
    else:
        R = R - dr / 2
        th = th0 + dth_expanded / 2

    xr = R * np.cos(th)
    yr = R * np.sin(th)
    zr = np.sqrt(np.maximum(1.0 - xr ** 2 - yr ** 2, 0.0))
    return np.stack([xr, yr, zr], axis=-1).astype(np.float32)


def vec2ss_matrix(v: torch.Tensor) -> torch.Tensor:
    """Batched skew-symmetric matrices [..., 3] -> [..., 3, 3]
    (reference isocell.py:131-141)."""
    zero = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zero], dim=-1),
    ], dim=-2)


def rotate_isocell(isocell_directions: torch.Tensor,
                   normal: torch.Tensor) -> torch.Tensor:
    """Rotate the +z-aligned isocell set so +z maps to ``-normal`` per point
    via the Rodrigues small-formula (reference isocell.py:144-171).

    isocell_directions [M, 3], normal [N, 3] -> [N, M, 3]."""
    normal = -normal
    b = normal / torch.linalg.norm(normal, dim=-1, keepdim=True)  # [N, 3]
    a = torch.tensor([0.0, 0.0, 1.0], dtype=b.dtype, device=b.device)
    v = torch.linalg.cross(a.expand_as(b), b)  # [N, 3]
    c = b[..., 2]  # a . b with a = e_z
    s2 = torch.sum(v * v, dim=-1)  # |v|^2 = s^2
    kmat = vec2ss_matrix(v)
    kmat2 = kmat @ kmat
    # the antiparallel singularity (s ~ 0, c ~ -1): the reference divides
    # by s^2 and gives inf there; the factor is 0 instead
    factor = torch.where(s2 > 1e-12, (1.0 - c) / torch.clamp_min(s2, 1e-12),
                         0.0)
    eye = torch.eye(3, dtype=b.dtype, device=b.device)
    rot = eye + kmat + kmat2 * factor[..., None, None]
    # dirs_rotated[n, m] = R[n] @ dir[m]
    return torch.einsum("nij,mj->nmi", rot, isocell_directions)
