"""Volumetric compositing math (reference: models/tensorBase.py:23-35)."""

from __future__ import annotations

import torch


def raw2alpha(sigma: torch.Tensor, dist: torch.Tensor):
    """sigma, dist [N_rays, N_samples] -> (alpha, weights, bg_weight).

    alpha_i   = 1 - exp(-sigma_i * dist_i)
    weights_i = alpha_i * T_i, T_i = prod_{j<i} (1 - alpha_j + 1e-10)
    bg_weight = T_N                    [N_rays, 1]
    """
    alpha = 1.0 - torch.exp(-sigma * dist)
    ones = torch.ones(alpha.shape[:-1] + (1,), dtype=alpha.dtype,
                      device=alpha.device)
    t = torch.cumprod(torch.cat([ones, 1.0 - alpha + 1e-10], dim=-1), dim=-1)
    return alpha, alpha * t[..., :-1], t[..., -1:]
