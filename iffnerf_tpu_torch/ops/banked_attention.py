"""Banked softmax-column-sum scoring against a precomputed ray bank.

For a bank K [R, D], queries q [P, D] and patch validity [P]:

    l[r, p]   = (K[r] . q[p]) / sqrt(D)        (scale applied to f32 logits)
    scores[r] = sum_p valid[p] * exp(l[r, p] - m[p]) / d[p]

with m[p], d[p] the max and softmax denominator of column p over all R
rays: the per-ray score of identification_module.py:162-168 without an
[R, P] logits array in device memory.

``banked_scores_fused`` launches the kernels of ``csrc/banked_attention.cu``
for CUDA tensors (they replace the TPU kernels ``_stats_kernel`` and
``_score_kernel`` of the JAX package's ``ops/banked_attention.py``) and
``banked_scores_plain`` for CPU tensors. q is cast to the bank dtype. Any
ray count runs through the kernels: the last tile is masked.

The bank is read twice on the card, once for the statistics and once for
the scores: d[p] is known only after every ray, and the logits (276 MB in
bf16 at 540 000 rays) would cost more to store than to recompute. Both
reads bound the pair: 0.248 ms at R = 540 000, D = 384 in bf16 on an H100
SXM (one read alone 0.124 ms). A bf16 bank (the inference path) runs a
persistent, warp-specialised kernel per pass on pairs of CTAs: TMA loads
the bank through a 16-chunk mbarrier ring, multicast to both CTAs of a
pair, each of which holds half of q and multiplies with ``wgmma``; its
depth must be a multiple of 64 up to 384. A float32 bank runs on float32
FMA tiles. Either way the bf16 products are exact and summed in float32,
which is what the plain version does by upcasting both operands. The
source's header note has the design.
"""

from __future__ import annotations

import ctypes
import math

import torch

from iffnerf_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "iff_banked_scores": [_P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P, _P,
                          _I, _P, _P, _P, _P, _P],
    "iff_banked_bf16_clusters": [],
}
_DTYPES = (torch.float32, torch.bfloat16)
PATCHES = 256   # the kernel's patch width (a 16 x 16 grid)
TILE_RAYS = 64  # rays per tile of either route
BF16_DEPTH_STEP, BF16_MAX_DEPTH = 64, 384  # bf16 depths: TMA boxes of 64


def _scale(d: int) -> float:
    return 1.0 / math.sqrt(d)


def softmax_scores(logits: torch.Tensor,
                   patch_valid: torch.Tensor) -> torch.Tensor:
    """scores [R] = softmax of ``logits`` [R, P] over the ray axis, summed
    over the valid patches: the epilogue shared by both kernels."""
    e = torch.exp(logits - logits.max(dim=0).values)
    return e @ (torch.where(patch_valid, 1.0, 0.0) / e.sum(dim=0))


def banked_scores_plain(bank: torch.Tensor, q: torch.Tensor,
                        patch_valid: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: scores [R] float32."""
    qs = q.to(bank.dtype).float()
    logits = (bank.float() @ qs.T) * _scale(bank.shape[1])     # [R, P]
    return softmax_scores(logits, patch_valid)


def _check(bank, q, patch_valid):
    if bank.dim() != 2 or bank.dtype not in _DTYPES:
        raise ValueError(f"bank must be [R, D] float32 or bfloat16, got "
                         f"{bank.dtype} {tuple(bank.shape)}")
    r, d = bank.shape
    if q.shape != (PATCHES, d) or patch_valid.shape != (PATCHES,):
        raise ValueError(f"q must be [{PATCHES}, {d}] and patch_valid "
                         f"[{PATCHES}], got {tuple(q.shape)} and "
                         f"{tuple(patch_valid.shape)}")
    d_ok = (d % BF16_DEPTH_STEP == 0 and d <= BF16_MAX_DEPTH
            if bank.dtype == torch.bfloat16 else d % 16 == 0)
    if not d_ok or r == 0:
        raise ValueError(f"bank depth must be a multiple of 16 (float32) or "
                         f"of {BF16_DEPTH_STEP} up to {BF16_MAX_DEPTH} "
                         f"(bfloat16), and R > 0; got {bank.dtype} "
                         f"{tuple(bank.shape)}")
    if q.device != bank.device or patch_valid.device != bank.device:
        raise ValueError("bank, q and patch_valid must share one device")
    if not bank.is_contiguous() or bank.data_ptr() % 16:
        raise ValueError("bank must be contiguous and 16-byte aligned")


def bf16_clusters() -> int:
    """The bf16 route's 2-CTA clusters that fit on the current card at
    once: the most that run, one a pair of SMs at best."""
    n = _build.load("banked_attention", _SIGNATURES).iff_banked_bf16_clusters()
    _build.check(min(n, 0), "banked_scores cluster query")
    return n


def banked_scores_fused(bank: torch.Tensor, q: torch.Tensor,
                        patch_valid: torch.Tensor) -> torch.Tensor:
    """Scores [R] float32 of ``bank`` [R, D] against ``q`` [256, D] with
    ``patch_valid`` [256] bool. CPU tensors take the plain version; CUDA
    tensors launch the kernel (three launches) or raise."""
    if bank.device.type == "cpu":
        return banked_scores_plain(bank, q, patch_valid)
    if bank.device.type != "cuda":
        raise ValueError(f"no banked-scoring kernel for {bank.device}")
    _check(bank, q, patch_valid)
    r, d = bank.shape
    lib = _build.load("banked_attention", _SIGNATURES)
    dev = bank.device
    # a bool is one byte of 0 or 1, read as such: no conversion launch
    valid = patch_valid.to(torch.bool).contiguous()
    sms = _build.sm_count(dev)
    tiles = -(-r // TILE_RAYS)
    bf16 = bank.dtype == torch.bfloat16
    if bf16:   # TMA reads q [P, D]: one cluster of two CTAs a pair of SMs
        qc = q.to(bank.dtype).contiguous()
        if qc.data_ptr() % 16:
            qc = qc.clone()
        nblocks = min(tiles, max(1, sms // 2))
    else:      # FMA tiles read q^T [D, P]
        qc = q.to(bank.dtype).T.contiguous()
        nblocks = min(tiles, 8 * sms)
    # part_m, part_d [nblocks, P] and m, d, w [P] in one allocation: the
    # estimate is host-bound, and each allocation costs host time
    scratch = torch.empty((2 * nblocks + 3) * PATCHES, dtype=torch.float32,
                          device=dev)
    part_m, part_d, m, dsum, w = (
        scratch.data_ptr() + 4 * PATCHES * rows
        for rows in (0, nblocks, 2 * nblocks, 2 * nblocks + 1, 2 * nblocks + 2))
    scores = torch.empty(r, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.iff_banked_scores(
        bank.data_ptr(), qc.data_ptr(), valid.data_ptr(), r, d, PATCHES,
        int(bf16), _scale(d), part_m, part_d, nblocks, m, dsum, w,
        scores.data_ptr(), stream)
    _build.check(rc, "banked_scores kernel launch")
    banked_scores_fused.launches += 1
    return scores


banked_scores_fused.launches = 0
