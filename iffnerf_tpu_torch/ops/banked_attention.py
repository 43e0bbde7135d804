"""Banked softmax-column-sum scoring against a precomputed ray bank.

For a bank K [R, D], queries q [P, D] and patch validity [P]:

    l[r, p]   = (K[r] . q[p]) / sqrt(D)        (scale applied to f32 logits)
    scores[r] = sum_p valid[p] * exp(l[r, p] - m[p]) / d[p]

with m[p], d[p] the max and softmax denominator of column p over all R
rays: the per-ray score of identification_module.py:162-168 without an
[R, P] logits array in device memory.

``banked_scores_fused`` launches the kernel of ``csrc/banked_attention.cu``
for CUDA tensors (it replaces the TPU kernels ``_stats_kernel`` and
``_score_kernel`` of the JAX package's ``ops/banked_attention.py``; the
source says what bounds it on an H100 and how it is built) and
``banked_scores_plain`` for CPU tensors. q is cast to the bank dtype. A
bf16 bank runs on the tensor cores (``mma.sync``), a float32 bank on
float32 FMAs; either way the bf16 products are exact and summed in
float32, which is what the plain version does by upcasting both operands.
Any ray count runs through the kernel: the last tile is masked.
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
}
_DTYPES = (torch.float32, torch.bfloat16)
PATCHES = 256   # the kernel's patch width (a 16 x 16 grid)
TILE_RAYS = 64  # rays per tile of the float32 kernel (8 blocks an SM)
TILE_RAYS_BF16 = 128  # rays per tile of the bf16 kernel (1 block an SM)


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
    d_ok = d % 32 == 0 and d <= 384 if bank.dtype == torch.bfloat16 \
        else d % 16 == 0
    if not d_ok or r == 0:
        raise ValueError(f"bank depth must be a multiple of 16 (float32) or "
                         f"of 32 up to 384 (bfloat16), and R > 0; got "
                         f"{bank.dtype} {tuple(bank.shape)}")
    if q.device != bank.device or patch_valid.device != bank.device:
        raise ValueError("bank, q and patch_valid must share one device")
    if not bank.is_contiguous() or bank.data_ptr() % 16:
        raise ValueError("bank must be contiguous and 16-byte aligned")


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
    valid = patch_valid.to(torch.uint8).contiguous()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if bank.dtype == torch.bfloat16:   # tensor-core tiles read q [P, D]
        qc = q.to(bank.dtype).contiguous()
        nblocks = min(-(-r // TILE_RAYS_BF16), sms)
    else:                              # FMA tiles read q^T [D, P]
        qc = q.to(bank.dtype).T.contiguous()
        nblocks = min(-(-r // TILE_RAYS), 8 * sms)
    f32 = dict(dtype=torch.float32, device=dev)
    part_m = torch.empty((nblocks, PATCHES), **f32)
    part_d = torch.empty((nblocks, PATCHES), **f32)
    m, dsum, w = (torch.empty(PATCHES, **f32) for _ in range(3))
    scores = torch.empty(r, **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.iff_banked_scores(
        bank.data_ptr(), qc.data_ptr(), valid.data_ptr(), r, d, PATCHES,
        int(bank.dtype == torch.bfloat16), _scale(d), part_m.data_ptr(),
        part_d.data_ptr(), nblocks, m.data_ptr(), dsum.data_ptr(),
        w.data_ptr(), scores.data_ptr(), stream)
    _build.check(rc, "banked_scores kernel launch")
    banked_scores_fused.launches += 1
    return scores


banked_scores_fused.launches = 0
