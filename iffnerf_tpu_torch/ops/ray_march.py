"""Volumetric compositing math (reference: models/tensorBase.py:23-35)."""

from __future__ import annotations

import torch


def exclusive_transmittance(alpha: torch.Tensor) -> torch.Tensor:
    """T_i = prod_{j<i} (1 - alpha_j + 1e-10), exclusive along the last axis
    -> [..., N+1]: the N exclusive products, then the full product (the
    background's transmittance)."""
    ones = torch.ones(alpha.shape[:-1] + (1,), dtype=alpha.dtype,
                      device=alpha.device)
    return torch.cumprod(torch.cat([ones, 1.0 - alpha + 1e-10], dim=-1),
                         dim=-1)


def raw2alpha(sigma: torch.Tensor, dist: torch.Tensor):
    """sigma, dist [N_rays, N_samples] -> (alpha, weights, bg_weight).

    alpha_i   = 1 - exp(-sigma_i * dist_i)
    weights_i = alpha_i * T_i          (T exclusive transmittance)
    bg_weight = T_N                    [N_rays, 1]
    """
    alpha = 1.0 - torch.exp(-sigma * dist)
    t = exclusive_transmittance(alpha)
    return alpha, alpha * t[..., :-1], t[..., -1:]
