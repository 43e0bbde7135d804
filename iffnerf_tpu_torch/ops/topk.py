"""Exact top-k of a float32 vector with the JAX package's tie order.

``jax.lax.top_k`` (and the package's block-wise ``exact_topk``) resolves
equal values to the LOWER index. ``torch.topk`` promises no order among
ties, so each score is packed with its index into one int64 key,

    key = ordered_bits(score) * 2**32 + (2**32 - 1 - index),

where ``ordered_bits`` maps float32 to int32 monotonically. The keys are
distinct, a larger key is a larger score or, on a tie, a lower index, and
one ``torch.topk`` over them is exact with no host round trip.
"""

from __future__ import annotations

import torch

from iffnerf_tpu_torch.tracing import span


def exact_topk(scores: torch.Tensor, k: int):
    """-> (values [k], indices [k] int64) of 1-D float32 ``scores``, in
    descending order, lower index first among equal values."""
    if scores.dtype != torch.float32 or scores.dim() != 1:
        raise ValueError(f"exact_topk takes a 1-D float32 vector, got "
                         f"{scores.dtype} {tuple(scores.shape)}")
    with span("pose.topk"):
        bits = scores.contiguous().view(torch.int32)
        # negative floats order backwards as signed ints: flip their magnitude
        ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF,
                              bits).to(torch.int64)
        idx = torch.arange(scores.shape[0], device=scores.device,
                           dtype=torch.int64)
        key = ordered * (1 << 32) + ((1 << 32) - 1 - idx)
        sel = torch.topk(key, k).indices
        return scores[sel], sel
