"""Closed-form pose geometry: weighted least-squares ray intersection,
look-at rotation, pose error metrics (reference pose_geometry.py:42-204,
errors.py:3-9).

The reference's NaN early returns are ``torch.where`` guards, so the solve
never waits on the host.
"""

from __future__ import annotations

import torch


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def det3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 determinant (scalar triple product of the rows)."""
    return (m[0] * _cross(m[1], m[2])).sum()


def inv3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse: M^-T rows are the cross products of M's
    rows over det."""
    c0 = _cross(m[1], m[2])
    c1 = _cross(m[2], m[0])
    c2 = _cross(m[0], m[1])
    det = (m[0] * c0).sum()
    return torch.stack([c0, c1, c2], dim=-1) / det


def solve3(m: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 linear solve; ``b`` is [3] or [3, k]."""
    return inv3(m) @ b


def compute_line_intersection_impl2(points: torch.Tensor,
                                    directions: torch.Tensor,
                                    weights: torch.Tensor | None = None):
    """Weighted LSQ intersection of N 3-D lines: R = sum w_i (I - d_i d_i^T),
    q = sum w_i (I - d_i d_i^T) p_i, solve R p = q; singular R -> NaN
    (reference pose_geometry.py:42-95)."""
    eye = torch.eye(directions.shape[-1], dtype=points.dtype,
                    device=points.device)
    projs = eye - directions[:, :, None] * directions[:, None, :]
    w = weights[:, None, None] if weights is not None else 1.0
    r_mat = (projs * w).sum(dim=0)
    q = ((projs @ points[:, :, None]) * w).sum(dim=0)
    solution = solve3(r_mat, q)[:, 0]
    singular = det3(r_mat) < 1e-7
    return torch.where(singular, torch.nan, solution)


def make_rotation_mat(direction: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Look-at rotation with rows [x; y; direction]
    (reference pose_geometry.py:175-196)."""
    xaxis = _cross(up, direction)
    xaxis = xaxis / torch.linalg.norm(xaxis, dim=-1, keepdim=True)
    yaxis = _cross(direction, xaxis)
    yaxis = yaxis / torch.linalg.norm(yaxis, dim=-1, keepdim=True)
    return torch.stack([xaxis, yaxis, direction], dim=-2)


def exclude_negatives(camera_optical_center: torch.Tensor,
                      sample_points: torch.Tensor,
                      dirs: torch.Tensor) -> torch.Tensor:
    """True where a ray points toward the camera center
    (reference pose_geometry.py:199-204)."""
    v = camera_optical_center[None] - sample_points
    return (v * dirs).sum(dim=-1) > 0


def compute_translation_error(t1: torch.Tensor, t2: torch.Tensor):
    """(reference errors.py:3-4)"""
    return torch.linalg.norm(t1 - t2)


def compute_angular_error(rotation_gt: torch.Tensor,
                          rotation_est: torch.Tensor):
    """Geodesic angle in degrees via the trace formula
    (reference errors.py:7-9)."""
    cos_angle = (
        torch.trace(rotation_gt @ torch.linalg.inv(rotation_est)) - 1.0
    ) / 2.0
    return torch.rad2deg(torch.arccos(torch.clip(cos_angle, -1.0, 1.0)))
