"""sRGB tone mapping (reference: models/image.py:6-23)."""

from __future__ import annotations

import torch


def linear_to_srgb(linear: torch.Tensor, eps: float | None = None) -> torch.Tensor:
    if eps is None:
        eps = float(torch.finfo(linear.dtype).eps)
    srgb0 = 323.0 / 25.0 * linear
    srgb1 = (211.0 * torch.clamp_min(linear, eps) ** (5.0 / 12.0) - 11.0) / 200.0
    return torch.where(linear <= 0.0031308, srgb0, srgb1)


def srgb_to_linear(srgb: torch.Tensor, eps: float | None = None) -> torch.Tensor:
    if eps is None:
        eps = float(torch.finfo(srgb.dtype).eps)
    linear0 = 25.0 / 323.0 * srgb
    linear1 = torch.clamp_min((200.0 * srgb + 11.0) / 211.0, eps) ** (12.0 / 5.0)
    return torch.where(srgb <= 0.04045, linear0, linear1)
