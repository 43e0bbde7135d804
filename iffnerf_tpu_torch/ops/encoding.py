"""Frequency positional encoding (reference: models/tensorBase.py:14-20).

Output ordering: ``[sin(x0*1), sin(x0*2), ..., sin(xK*2^{F-1}), cos(x0*1),
...]`` -- the per-channel frequency products flattened channel-major, then
the sin block followed by the cos block.
"""

from __future__ import annotations

import torch


def positional_encoding(positions: torch.Tensor, freqs: int) -> torch.Tensor:
    """positions [..., K] -> [..., 2*K*freqs]."""
    freq_bands = 2.0 ** torch.arange(freqs, dtype=positions.dtype,
                                     device=positions.device)
    pts = (positions[..., None] * freq_bands).reshape(
        positions.shape[:-1] + (freqs * positions.shape[-1],)
    )
    return torch.cat([torch.sin(pts), torch.cos(pts)], dim=-1)
