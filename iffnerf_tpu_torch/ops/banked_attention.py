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
bf16 at 540 000 rays) would cost more to store than to recompute. Each
pass is a persistent, warp-specialised kernel on clusters of CTAs, one an
SM, that split the patch axis: TMA loads bank chunks into an mbarrier ring,
each CTA a share of a chunk multicast to the cluster, and consumer
warpgroups multiply with ``wgmma``.

- bf16 (the inference path): 2-CTA clusters, 128 patches of q a CTA, one
  ``wgmma`` product a step; the bank's two reads bound the pair, 0.248 ms
  at R = 540 000, D = 384 on an H100 SXM. Depths: multiples of 64 up to
  384.
- float32: 4-CTA clusters, 64 patches a CTA. The products run in TF32
  split in three (hi = x rounded to TF32, lo = x - hi; hi*lo + lo*hi +
  hi*hi, lo*lo dropped), which keeps float32 accuracy: three TF32 products
  of both passes bound the pair at 1.29 ms (operations), the bank's two
  reads at 0.495 ms. Depths: multiples of 32 up to 384.

Either way the products are summed in float32, which is what the plain
version does by upcasting both operands. ``kernel_takes`` says which
shapes the kernel takes; the wrapper raises on others, and ``score_rays``
sends them to its exact path. The source's header note has the design.
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
                          _I, _P, _P, _P, _P, _P, _P],
    "iff_banked_clusters": [_I],
}
_DTYPES = (torch.float32, torch.bfloat16)
PATCHES = 256   # the kernel's patch width (a 16 x 16 grid)
TILE_RAYS = 64  # rays per tile of either route
MAX_DEPTH = 384
# depth of a TMA box (128 bytes) and CTAs of a cluster, by bank dtype
DEPTH_STEP = {torch.bfloat16: 64, torch.float32: 32}
CLUSTER_CTAS = {torch.bfloat16: 2, torch.float32: 4}


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


def kernel_takes(dtype, p: int, d: int) -> bool:
    """Whether the kernel takes a bank of ``dtype`` and depth ``d`` against
    ``p`` patches: 256 patches, and a depth that is a multiple of 64
    (bfloat16) or 32 (float32) up to 384."""
    return (dtype in DEPTH_STEP and p == PATCHES and 0 < d <= MAX_DEPTH
            and d % DEPTH_STEP[dtype] == 0)


def _check(bank, q, patch_valid):
    if bank.dim() != 2 or bank.dtype not in _DTYPES:
        raise ValueError(f"bank must be [R, D] float32 or bfloat16, got "
                         f"{bank.dtype} {tuple(bank.shape)}")
    r, d = bank.shape
    if q.shape != (PATCHES, d) or patch_valid.shape != (PATCHES,):
        raise ValueError(f"q must be [{PATCHES}, {d}] and patch_valid "
                         f"[{PATCHES}], got {tuple(q.shape)} and "
                         f"{tuple(patch_valid.shape)}")
    if not kernel_takes(bank.dtype, q.shape[0], d) or r == 0:
        raise ValueError(f"bank depth must be a multiple of "
                         f"{DEPTH_STEP[bank.dtype]} up to {MAX_DEPTH} for "
                         f"{bank.dtype}, and R > 0; got {tuple(bank.shape)}")
    if q.device != bank.device or patch_valid.device != bank.device:
        raise ValueError("bank, q and patch_valid must share one device")
    if not bank.is_contiguous() or bank.data_ptr() % 16:
        raise ValueError("bank must be contiguous and 16-byte aligned")


def resident_clusters(dtype) -> int:
    """The clusters of the route for ``dtype`` (2 CTAs for bfloat16, 4 for
    float32) that fit on the current card at once: the most that run."""
    lib = _build.load("banked_attention", _SIGNATURES)
    n = lib.iff_banked_clusters(int(dtype == torch.bfloat16))
    _build.check(min(n, 0), "banked_scores cluster query")
    return n


def banked_scores_fused(bank: torch.Tensor, q: torch.Tensor,
                        patch_valid: torch.Tensor) -> torch.Tensor:
    """Scores [R] float32 of ``bank`` [R, D] against ``q`` [256, D] with
    ``patch_valid`` [256] bool. CPU tensors take the plain version; CUDA
    tensors launch the kernel (three launches for bfloat16, four for
    float32) or raise."""
    if bank.device.type == "cpu":
        return banked_scores_plain(bank, q, patch_valid)
    if bank.device.type != "cuda":
        raise ValueError(f"no banked-scoring kernel for {bank.device}")
    _check(bank, q, patch_valid)
    _build.refuse_grad("banked_scores_fused", (bank, q))
    r, d = bank.shape
    lib = _build.load("banked_attention", _SIGNATURES)
    dev = bank.device
    # a bool is one byte of 0 or 1, read as such: no conversion launch
    valid = patch_valid.to(torch.bool).contiguous()
    qc = q.to(bank.dtype).contiguous()   # TMA reads q [P, D]
    if qc.data_ptr() % 16:
        qc = qc.clone()
    ctas = CLUSTER_CTAS[bank.dtype]
    # one cluster a group of SMs at most (the kernel clamps to those that
    # fit at once) and no more than the 64-ray tiles
    nblocks = min(-(-r // TILE_RAYS), max(1, _build.sm_count(dev) // ctas))
    # part_m, part_d [nblocks, P], m, d, w [P] and, for float32, each CTA's
    # share of the scores [4, R] in one allocation: the estimate is
    # host-bound, and each allocation costs host time
    f32 = bank.dtype == torch.float32
    rows = 2 * nblocks + 3
    scratch = torch.empty(rows * PATCHES + (ctas * r if f32 else 0),
                          dtype=torch.float32, device=dev)
    part_m, part_d, m, dsum, w, shares = (
        scratch.data_ptr() + 4 * PATCHES * k
        for k in (0, nblocks, 2 * nblocks, 2 * nblocks + 1, 2 * nblocks + 2,
                  rows))
    scores = torch.empty(r, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.iff_banked_scores(
        bank.data_ptr(), qc.data_ptr(), valid.data_ptr(), r, d, PATCHES,
        int(not f32), _scale(d), part_m, part_d, nblocks, m, dsum, w,
        shares if f32 else None, scores.data_ptr(), stream)
    _build.check(rc, "banked_scores kernel launch")
    banked_scores_fused.launches += 1
    return scores


banked_scores_fused.launches = 0
