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


def _cross_product_system(points, directions, weights=None):
    """The A, b of the cross-product solvers (reference
    pose_geometry.py:4-21,148-166): each consecutive ray pair gives the row
    cross(d_i, d_i+1) with the right-hand side p_i+1 . row. Rows of a
    parallel pair (|cross| < 1e-7) are zeroed, as the JAX package zeroes
    them: zero rows leave the least-squares normal equations unchanged."""
    cross = _cross(directions[:-1], directions[1:])
    a_mat = cross
    b = (points[1:] * cross).sum(dim=-1)
    if weights is not None:
        a_mat = a_mat * weights[1:, None]
        b = b * weights[1:]
    keep = ~torch.all(torch.abs(cross) < 1e-7, dim=-1)
    return a_mat * keep[:, None], b * keep


def _lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The minimum-norm least-squares solution of a x = b, through the
    pseudo-inverse with the cut-off of ``jnp.linalg.lstsq`` (singular
    values below eps x max(m, n) of the largest dropped); on any device,
    where ``torch.linalg.lstsq``'s CUDA driver takes full rank only."""
    return torch.linalg.pinv(a) @ b


def compute_line_intersection(points: torch.Tensor, directions: torch.Tensor,
                              weights: torch.Tensor | None = None):
    """Cross-product LSQ intersection (reference pose_geometry.py:4-39):
    A = cross(d_i, d_i+1), b = p_i+1 . A_i, lstsq(A, b). A NaN solution
    becomes ones, as in the reference."""
    a_mat, b = _cross_product_system(points, directions, weights)
    solution = _lstsq(a_mat, b)
    return torch.where(torch.isnan(solution).any(), torch.ones_like(solution),
                       solution)


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


def compute_line_intersection_impl3(points: torch.Tensor,
                                    directions: torch.Tensor,
                                    weights: torch.Tensor | None = None):
    """impl2's normal equations with the weights on both the projector sum
    and the right-hand side, solved by least squares: a singular projector
    sum gives the minimum-norm solution, not NaN (reference
    pose_geometry.py:98-126)."""
    eye = torch.eye(3, dtype=points.dtype, device=points.device)
    projs = eye - directions[:, :, None] * directions[:, None, :]
    b = projs @ points[:, :, None]
    if weights is not None:
        projs = projs * weights[:, None, None]
        b = b * weights[:, None, None]
    return _lstsq(projs.sum(dim=0), b.sum(dim=0))[:, 0]


def _irls(y: torch.Tensor, x_mat: torch.Tensor, maxiter: int,
          w_init: float = 1.0, d: float = 1e-4,
          tolerance: float = 1e-3) -> torch.Tensor:
    """Iteratively reweighted least squares with the L1 (1 / residual)
    weight update (reference pose_geometry.py:129-145). The reference's
    early exit (the JAX package's while-loop condition) is a flag: all
    ``maxiter`` rounds run, and a round after the one whose change fell
    below ``tolerance`` keeps the solution as it was, so that the loop
    never waits on the host."""
    def weighted_solve(w):
        xtw = x_mat.T * w[None, :]
        return _lstsq(xtw @ x_mat, xtw @ y)

    beta = weighted_solve(torch.full((y.shape[0],), w_init,
                                     dtype=x_mat.dtype, device=x_mat.device))
    done = torch.zeros((), dtype=torch.bool, device=x_mat.device)
    for _ in range(maxiter):
        resid = torch.abs(y - x_mat @ beta)
        new_beta = weighted_solve(1.0 / torch.clamp(resid, min=d))
        tol = torch.abs(new_beta - beta).sum()
        beta = torch.where(done, beta, new_beta)
        done = done | (tol < tolerance)
    return beta


def compute_line_intersection_impl4(points: torch.Tensor,
                                    directions: torch.Tensor,
                                    weights: torch.Tensor | None = None):
    """Robust (IRLS) variant of the cross-product solver (reference
    pose_geometry.py:148-171): outlier rays weighted down by 1 / |residual|
    over up to 100 rounds."""
    a_mat, b = _cross_product_system(points, directions, weights)
    return _irls(b, a_mat, maxiter=100)


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
