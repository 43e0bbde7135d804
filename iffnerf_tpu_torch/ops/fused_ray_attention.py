"""Fused ray MLP + k projection + logits for the unbanked pose scoring.

For ray inputs x [R, 141] (``id_module.ray_mlp_inputs``) the chain is the
ray MLP (141 -> 256 -> 256, skip concat ``[h, x]`` -> 397 -> 256 -> 384),
the k projection (384 -> 384) and the logits against the queries, which
carry the 1/sqrt(D) scale. Every layer accumulates in float32, adds the
bias, applies its ReLU and rounds to the working dtype. The softmax over
the ray axis then gives the scores:

    scores[r] = sum_p valid[p] * exp(l[r, p] - m[p]) / d[p]

``fused_ray_scores`` launches the kernel of ``csrc/fused_ray_attention.cu``
for CUDA tensors (it replaces the TPU kernel ``_kernel`` of the JAX
package's ``ops/fused_ray_attention.py``; the source says what bounds it
on an H100 and how it is built), which writes the logits and the softmax
statistics. Both routes stream the weights through a ring of shared
memory as the B operand of ``wgmma``, cut into k-steps that the wrapper
lays out as shared memory holds them: bf16 as one product a 16-deep step
(``_bf16_steps``), float32 as three TF32 products an 8-deep step (the
weights split into TF32 hi and lo, ``_step_image``). The weights' steps
are made once per set of parameters and dtype, the queries' once a call.
The epilogue ``exp(l - m) @ w`` stays in torch, as it stayed outside the
TPU kernel. CPU tensors take ``fused_ray_scores_plain``. Any ray count
runs through the kernel: the last tile is masked.
"""

from __future__ import annotations

import ctypes
import math

import torch

from iffnerf_tpu_torch.ops import _build
from iffnerf_tpu_torch.ops.banked_attention import PATCHES, softmax_scores

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I,
             _P, _P, _P, _P, _I, _P, _P, _P, _P]   # both routes take the same
_SIGNATURES = {"iff_fused_ray_scores_f32": _ARGTYPES,
               "iff_fused_ray_scores_bf16": _ARGTYPES}
BF16_WIDTHS = (128, 256, 384, 512)  # layer widths of the bf16 route (wgmma N 64-256)
F32_WIDTHS = (128, 256, 384)        # of the float32 route (wgmma N 64-192)
TILE_RAYS = 64  # rays per tile of either route (kRays)
# the kernel's shared memory (csrc/fused_ray_attention.cu, ws::ring_stages)
_SMEM_BYTES, _MAX_STAGES, _CHUNK_BYTES = 232448, 8, 64 * 128
_CHUNK, _STEP = 32, 8  # float32: depth of an activation chunk, of a step
# bf16: depth of an activation chunk, of a step (one bf16 k-step), and
# steps a ring stage (bf::kStageSteps)
_BF16_CHUNK, _BF16_STEP, _BF16_STAGE_STEPS = 64, 16, 4
_LAYERS = (("ray_mlp", 0), ("ray_mlp", 1), ("ray_mlp2", 0), ("ray_mlp2", 1),
           ("k_proj", None))
_NET = {}  # dtype -> the kernel's weights for the last params seen, see _kernel_net


def _sources(params):
    return [params[n] if i is None else params[n][i] for n, i in _LAYERS]


def _layers(params, dt):
    """[(w [in, out], b [out])] of the five ray-side layers in ``dt``."""
    return [(layer["w"].to(dt).contiguous(), layer["b"].to(dt).contiguous())
            for layer in _sources(params)]


def _tf32_split(w):
    """(hi, lo) of float32 ``w``: hi rounded to TF32 (10 mantissa bits, to
    nearest, ties away from zero: ``cvt.rna.tf32.f32``), lo = w - hi,
    which is exact."""
    bits = w.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return hi, w - hi


def _step_image(segments):
    """The float32 kernel's steps of one layer: ``segments`` are the parts
    of its weight [K_i, N] that meet the parts of its input in turn (the
    skip layer: the h2 rows, then the x rows), each padded with zero rows
    to a multiple of 32. -> [steps * 2N, 8]: for each step of 8 deep, the
    N rows of hi, then of lo, of w^T. Within a 32-deep chunk, step kk's
    column c is depth 8 (c % 4) + 2 kk + c // 4, the order in which the
    kernel reads an activation chunk into its registers."""
    steps = []
    for w in segments:
        k, n = w.shape
        wt = torch.nn.functional.pad(w.T, (0, -k % _CHUNK))   # [N, kc * 32]
        # depth 8a + 2kk + b (a < 4, kk < 4, b < 2) -> step kk, column a + 4b
        wt = wt.reshape(n, -1, 4, 4, 2).permute(1, 3, 0, 4, 2)
        steps.append(wt.reshape(-1, n, _STEP))
    hi, lo = _tf32_split(torch.cat(steps))                     # [S, N, 8]
    return torch.stack([hi, lo], 1).reshape(-1, _STEP)


def _bf16_steps(segments):
    """The bf16 kernel's steps of one layer: ``segments`` are the parts of
    its weight [K_i, N] that meet the parts of its input in turn (the skip
    layer: the h2 rows, then the x rows), each padded with zero rows to
    whole ring stages (a multiple of 64 deep). -> [steps * N, 16]: for each
    step of 16 deep, the N rows of w^T."""
    depth = _BF16_STEP * _BF16_STAGE_STEPS
    steps = []
    for w in segments:
        k, n = w.shape
        wt = torch.nn.functional.pad(w.T, (0, -k % depth))      # [N, K']
        steps.append(wt.reshape(n, -1, _BF16_STEP).transpose(0, 1).reshape(-1, _BF16_STEP))
    return torch.cat(steps)


def _swizzle32(steps):
    """Steps [rows, 8 float32 or 16 bf16] -> the bytes that the kernel's
    shared memory holds for them, rows of 32 bytes with the 32-byte
    swizzle: the two 16-byte halves of rows 4-7 of each 8-row atom
    swapped. Its own inverse. The kernel copies each step as it is, to a
    stage at a 1024-byte boundary."""
    c = steps.shape[1]
    x = steps.reshape(-1, 2, 4, 2, c // 2)   # atom, rows 0-3 | 4-7, row, half
    return torch.cat([x[:, :1], x[:, 1:].flip(3)], 1).reshape(-1, c)


def _steps(dt):
    """The step layout of ``dt``'s route: ``_bf16_steps`` or ``_step_image``."""
    return _bf16_steps if dt == torch.bfloat16 else _step_image


def _net_image(layers, steps):
    """Steps of the five ray-side layers, in the kernel's order, each laid
    out by ``steps`` (``_steps``)."""
    (w1, _), (w2, _), (w3, _), (w4, _), (wk, _) = layers
    h2 = w2.shape[1]
    return torch.cat([steps([w1]), steps([w2]), steps([w3[:h2], w3[h2:]]),
                      steps([w4]), steps([wk])])


def _kernel_net(params, dt):
    """(layers, steps) for the kernel: the five layers in ``dt`` and their
    steps (``_net_image``: bf16 ``_bf16_steps``, float32 the TF32-split
    ``_step_image``) as shared memory holds them. Built once for a set of
    parameter tensors and a dtype, and reused while the same tensors,
    unmodified in place, come back: per image only the rays change. Each
    dtype keeps its own entry, so routes that alternate reuse both."""
    src = [t for layer in _sources(params) for t in (layer["w"], layer["b"])]
    versions = tuple(t._version for t in src)
    entry = _NET.get(dt)
    if (entry is None or entry["versions"] != versions
            or any(a is not b for a, b in zip(entry["src"], src))):
        layers = _layers(params, dt)
        _check_widths(layers, dt)
        entry = _NET[dt] = dict(src=src, versions=versions, net=(
            layers, _swizzle32(_net_image(layers, _steps(dt)))))
    return entry["net"]


def scaled_queries(q: torch.Tensor, dt) -> torch.Tensor:
    """qs [D, P] = (q / sqrt(D)).T in ``dt``. The divisor is rounded to
    q's dtype first: the JAX package divides a bf16 q by a weakly typed
    Python float, which it casts to bf16 (sqrt(384) -> 19.625)."""
    div = torch.full((), math.sqrt(q.shape[1]), dtype=q.dtype, device=q.device)
    return (q / div).T.to(dt).contiguous()


def layer_widths(params) -> tuple:
    """(in, h1, h2, h3, dk): the ray MLP's input and the outputs of the
    four ray-side layers (the k projection maps dk to dk)."""
    w1, w2, w3, w4, _ = (layer["w"] for layer in _sources(params))
    return w1.shape[0], w1.shape[1], w2.shape[1], w3.shape[1], w4.shape[1]


def _ring_stages(act_chunks, slot):
    return min(_MAX_STAGES, (_SMEM_BYTES - 1024 - 16 * _MAX_STAGES
                             - act_chunks * _CHUNK_BYTES) // slot)


def f32_stages(widths) -> int:
    """Ring stages of the float32 route at these ``widths``: the shared
    memory that its activations leave (x, the h1/h2/h3 buffer, and h4
    and k over both) over a stage's bytes (hi and lo of the widest
    layer's step), at most 8 (``f32::plan`` in the source)."""
    in_dim, h1, h2, h3, dk = widths
    xc, hc = -(-in_dim // _CHUNK), max(h1, h2, h3) // _CHUNK
    slot = 2 * max(h1, h2, h3, dk, PATCHES) * _STEP * 4
    return _ring_stages(max(hc + xc, dk // _CHUNK), slot)


def bf16_stages(widths) -> int:
    """Ring stages of the bf16 route at these ``widths``: the shared
    memory that its activations leave (the h1/h2/h3 buffer from chunk 0,
    x from chunk max(hc, xc) so that the next tile's x can be staged in
    chunks [0, xc), h4 and k over all of them) over a stage's bytes (four
    16-deep steps of the widest layer), at most 8 (``bf::plan`` in the
    source). At the model's widths 7 chunks (56 KB) leave 3 stages of
    48 KB."""
    in_dim, h1, h2, h3, dk = widths
    xc, hc = -(-in_dim // _BF16_CHUNK), max(h1, h2, h3) // _BF16_CHUNK
    act = max(max(hc, xc) + xc, dk // _BF16_CHUNK)
    slot = _BF16_STAGE_STEPS * max(h1, h2, h3, dk, PATCHES) * _BF16_STEP * 2
    return _ring_stages(act, slot)


def kernel_takes(dtype, p: int, widths) -> bool:
    """Whether the kernel takes this shape: ``dtype`` float32 or bfloat16,
    ``p`` patches and the ray layers' ``widths`` (``layer_widths``). The
    callers score any other shape on the exact torch path, as the JAX
    package falls back to XLA where its kernel cannot tile."""
    in_dim, h1, h2, h3, dk = widths
    if p != PATCHES or in_dim <= 0:
        return False
    if dtype == torch.bfloat16:
        return (all(n in BF16_WIDTHS for n in (h1, h2, h3, dk))
                and bf16_stages(widths) >= 2)
    return (dtype == torch.float32
            and all(n in F32_WIDTHS for n in (h1, h2, h3, dk))
            and f32_stages(widths) >= 2)


def _check_widths(layers, dt):
    (w1, _), (w2, _), (w3, _), (w4, _), _ = layers
    in_dim, h1, h2, h3, dk = (w1.shape[0], w1.shape[1], w2.shape[1],
                              w3.shape[1], w4.shape[1])
    expect = [(in_dim, h1), (h1, h2), (h2 + in_dim, h3), (h3, dk), (dk, dk)]
    if [tuple(w.shape) for w, _ in layers] != expect:
        raise ValueError(f"layer shapes {[tuple(w.shape) for w, _ in layers]} "
                         f"do not chain")
    if not kernel_takes(dt, PATCHES, (in_dim, h1, h2, h3, dk)):
        raise ValueError(f"unsupported widths {(in_dim, h1, h2, h3, dk)} in "
                         f"{dt}: the bf16 route takes {BF16_WIDTHS}, the "
                         f"float32 one {F32_WIDTHS}, each with two ring "
                         f"stages of shared memory")


def fused_ray_scores_plain(params, q, patch_valid, x):
    """The kernel's function in plain torch: scores [R] float32."""
    dt = x.dtype
    (w1, b1), (w2, b2), (w3, b3), (w4, b4), (wk, bk) = _layers(params, dt)

    def layer(h, w, b, relu):
        y = h.float() @ w.float() + b.float()
        return (torch.relu(y) if relu else y).to(dt)

    h = layer(x, w1, b1, True)
    h = layer(h, w2, b2, True)
    h = layer(torch.cat([h, x], dim=-1), w3, b3, True)
    h = layer(h, w4, b4, False)
    k = layer(h, wk, bk, False)
    logits = k.float() @ scaled_queries(q, dt).float()           # [R, P]
    return softmax_scores(logits, patch_valid)


def fused_ray_scores(params, q, patch_valid, x):
    """Scores [R] float32 for all candidate rays.

    params: the id-module parameter dict (ray_mlp / ray_mlp2 / k_proj).
    q: [256, D] image queries in the compute dtype; patch_valid: [256] bool.
    x: [R, 141] ray-MLP inputs in the compute dtype (float32 or bfloat16).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (two launches, then the torch epilogue) or raise."""
    if x.device.type == "cpu":
        return fused_ray_scores_plain(params, q, patch_valid, x)
    if x.device.type != "cuda":
        raise ValueError(f"no fused ray-scoring kernel for {x.device}")
    _build.refuse_grad("fused_ray_scores", [x, q] + [
        t for layer in _sources(params) for t in (layer["w"], layer["b"])])
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16) or x.dim() != 2:
        raise ValueError(f"x must be [R, in] float32 or bfloat16, got "
                         f"{dt} {tuple(x.shape)}")
    if q.shape[0] != PATCHES or patch_valid.shape != (PATCHES,):
        raise ValueError(f"q must be [{PATCHES}, D] and patch_valid "
                         f"[{PATCHES}], got {tuple(q.shape)} and "
                         f"{tuple(patch_valid.shape)}")
    if not x.is_contiguous() or x.shape[0] == 0:
        raise ValueError("x must be contiguous and hold at least one ray")
    if dt == torch.bfloat16 and x.data_ptr() % 16:
        raise ValueError("bf16 x must start at a 16-byte boundary: the "
                         "kernel copies each tile's rows 16 bytes at a time")
    layers, steps = _kernel_net(params, dt)
    (w1, b1), (w2, b2), (w3, b3), (w4, b4), (wk, bk) = layers
    r, in_dim = x.shape
    h1, h2, h3, dk = w1.shape[1], w2.shape[1], w3.shape[1], w4.shape[1]
    if w1.shape[0] != in_dim or q.shape[1] != dk:
        raise ValueError(f"the ray layers take {w1.shape[0]} inputs and give "
                         f"{dk} features; got x {tuple(x.shape)} and q "
                         f"{tuple(q.shape)}")
    dev = x.device
    if any(t.device != dev for t in (q, patch_valid, w1)):
        raise ValueError("params, q, patch_valid and x must share one device")
    lib = _build.load("fused_ray_attention", _SIGNATURES)
    qs = scaled_queries(q, dt)                                  # [D, P]
    valid = patch_valid.to(torch.uint8).contiguous()
    nblocks = _build.sm_count(dev)  # the partial rows: a CTA an SM at most
    f32 = dict(dtype=torch.float32, device=dev)
    logits = torch.empty((r, PATCHES), **f32)
    part_m = torch.empty((nblocks, PATCHES), **f32)
    part_d = torch.empty((nblocks, PATCHES), **f32)
    m, dsum, w = (torch.empty(PATCHES, **f32) for _ in range(3))
    q_steps = _swizzle32(_steps(dt)([qs]))
    launch = (lib.iff_fused_ray_scores_bf16 if dt == torch.bfloat16
              else lib.iff_fused_ray_scores_f32)
    rc = launch(
        x.data_ptr(), r, in_dim, h1, h2, h3, dk, steps.data_ptr(),
        steps.shape[0], b1.data_ptr(), b2.data_ptr(), b3.data_ptr(),
        b4.data_ptr(), bk.data_ptr(), q_steps.data_ptr(), PATCHES,
        valid.data_ptr(), logits.data_ptr(), part_m.data_ptr(),
        part_d.data_ptr(), nblocks, m.data_ptr(), dsum.data_ptr(),
        w.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "fused_ray_scores kernel launch")
    fused_ray_scores.launches += 1
    return torch.exp(logits - m) @ w


fused_ray_scores.launches = 0
