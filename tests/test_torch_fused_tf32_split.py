"""The float32 route of the fused ray-scoring kernel runs every layer on
TF32 tensor cores, split in three: for an activation a = hi_a + lo_a and a
weight w = hi_w + lo_w (hi rounded to TF32, lo the rest, read by the tensor
cores truncated to 10 mantissa bits), a . w ~ hi_a . lo_w + lo_a . hi_w +
hi_a . hi_w. The wrapper lays the weights out once per set of parameters
as the kernel's steps (``_kernel_net``: w^T split into hi and lo, cut into
steps of 8 deep, the depth permuted within each 32-deep chunk as the
kernel reads its activations), and the queries so for each call.

This emulates the kernel's arithmetic in numpy from those very layouts:
each layer's activations are permuted and split as the kernel splits them
in registers, the three products of each step are exact in float64 and
rounded once, then the bias and the ReLU. The scores it gives are held to
the JAX package's Pallas kernel (interpret mode, float32) at the kernel's
tolerance, and one TF32 product alone misses it, which shows that the
check can fail. The kernel itself is held to its plain version on the
card (tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iffnerf_tpu.ops.fused_ray_attention import fused_ray_scores as jfused
from iffnerf_tpu_torch.ops import fused_ray_attention as fused
from iffnerf_tpu_torch.ops.banked_attention import softmax_scores
from iffnerf_tpu_torch.pose import id_module as tid

from torch_parity import configs, params, scene

R = 2048
RTOL = 1e-5      # the kernel's tolerance against its plain version
MAX_REL = 5e-6   # and its largest relative score error


def tf32_truncate(x):
    """The top 19 bits of a float32, as the tensor cores read an operand."""
    return (x.astype(np.float32).view(np.uint32)
            & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_round(x):
    """To nearest TF32, ties away from zero (cvt.rna.tf32.f32)."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def as_steps(a):
    """Activations [R, K] (K a multiple of 32) -> [R, K / 8, 8] in the
    kernel's order: step kk of a 32-deep chunk holds, at column c, depth
    8 (c % 4) + 2 kk + c // 4 of the chunk."""
    r, k = a.shape
    return a.reshape(r, k // 32, 4, 4, 2).transpose(0, 1, 3, 4, 2).reshape(r, -1, 8)


def pad32(a):
    return np.pad(a, ((0, 0), (0, -a.shape[1] % 32)))


def layer_images(image, widths, steps):
    """The net's step image [rows, 8] cut into each layer's hi and lo,
    [steps, N, 8] each."""
    out, row = [], 0
    for n, s in zip(widths, steps):
        part = image[row:row + s * 2 * n].reshape(s, 2, n, 8)
        out.append((part[:, 0], part[:, 1]))
        row += s * 2 * n
    assert row == image.shape[0]
    return out


def kernel_layer(segments, hi_w, lo_w, products):
    """The products of one layer over its input ``segments`` (each padded
    to 32 deep), as the kernel forms them from its steps."""
    a = as_steps(np.concatenate([pad32(s) for s in segments], axis=1))
    hi_a = tf32_round(a)

    def dot(u, v):   # TF32 operands: every product exact, summed in float64
        u = tf32_truncate(u).reshape(u.shape[0], -1).astype(np.float64)
        v = tf32_truncate(v).transpose(1, 0, 2).reshape(v.shape[1], -1)
        return u @ v.astype(np.float64).T

    if products == 1:
        return dot(hi_a, hi_w).astype(np.float32)
    small = dot(hi_a, lo_w).astype(np.float32) + dot(a - hi_a, hi_w).astype(np.float32)
    return small + dot(hi_a, hi_w).astype(np.float32)


def kernel_scores(tp, x, qs, valid, products):
    """The float32 kernel's scores, emulated from the wrapper's layouts."""
    (w1, b1), (w2, b2), (w3, b3), (w4, b4), (wk, bk) = [
        (w.numpy(), b.numpy()) for w, b in fused._layers(tp, torch.float32)]
    layers, image = fused._kernel_net(tp, torch.float32)
    image = fused._swizzle32(image)     # the steps, as the kernel reads them
    h1, h2, h3, dk = w1.shape[1], w2.shape[1], w3.shape[1], w4.shape[1]
    xs = -(-x.shape[1] // 32) * 4
    imgs = layer_images(image.numpy(), (h1, h2, h3, dk, dk),
                        (xs, h1 // 8, h2 // 8 + xs, h3 // 8, dk // 8))
    q_hi, q_lo = layer_images(fused._step_image([torch.from_numpy(qs)]).numpy(),
                              (qs.shape[1],), (dk // 8,))[0]

    def layer(segments, i, b, relu):
        y = kernel_layer(segments, *imgs[i], products) + b
        return np.maximum(y, 0) if relu else y

    h = layer([x], 0, b1, True)
    h = layer([h], 1, b2, True)
    h = layer([h, x], 2, b3, True)
    h = layer([h], 3, b4, False)
    k = layer([h], 4, bk, False)
    logits = kernel_layer([k], q_hi, q_lo, products)
    return softmax_scores(torch.from_numpy(logits), torch.from_numpy(valid)).numpy()


@pytest.fixture(scope="module")
def case():
    """The JAX package's initial ID module (float32), 2048 candidate rays
    through ray_mlp_inputs, N(0, 1) queries (which give logits of order
    ten, where one TF32 product's error shows in the scores) and about
    30 % of the patches invalid."""
    jcfg, tcfg = configs()
    jp, tp = params(31, jcfg)
    s = scene(31, R)
    rays = [torch.from_numpy(s[k]) for k in ("rays_ori", "rays_dirs", "rays_rgb")]
    x = tid.ray_mlp_inputs(tcfg, *rays).numpy()
    rng = np.random.default_rng(31)
    q = rng.standard_normal((256, 384), dtype=np.float32)
    valid = rng.random(256) > 0.3
    want = np.asarray(jfused(jp, jnp.asarray(q), jnp.asarray(valid),
                             jnp.asarray(x), tile=256, interpret=True))
    qs = fused.scaled_queries(torch.from_numpy(q), torch.float32).numpy()
    return tp, x, qs, valid, want


def _max_rel(got, want):
    return float((np.abs(got - want) / np.abs(want)).max())


def test_step_image_splits_the_weights_exactly():
    """hi + lo gives w^T back bit for bit, in the kernel's depth order;
    hi's low 13 bits are zero and |lo| is at most half a TF32 ulp of w."""
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((141, 256)) * rng.uniform(1e-3, 10, (141, 256))).astype(np.float32)
    img = fused._step_image([torch.from_numpy(w)]).numpy().reshape(-1, 2, 256, 8)
    hi, lo = img[:, 0], img[:, 1]
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    np.testing.assert_array_equal(hi, tf32_round(hi + lo))
    back = (hi + lo).transpose(1, 0, 2).reshape(256, -1, 8)     # [N, steps, 8]
    want = as_steps(pad32(w.T))                                 # w^T permuted
    np.testing.assert_array_equal(back, want)
    assert (np.abs(lo) <= np.abs(hi) * 2.0 ** -11).all()


def test_swizzle_swaps_the_halves_of_rows_4_to_7_of_each_atom():
    """Byte (row, b) of a 32-byte-swizzled tile lies at row * 32 +
    ((b // 16) ^ (row // 4 % 2)) * 16 + b % 16 (csrc/tma_wgmma.cuh); the
    swizzle is its own inverse."""
    steps = torch.arange(64 * 8, dtype=torch.float32).reshape(64, 8)
    got = fused._swizzle32(steps)
    for row in range(64):
        for c in range(8):
            want_at = ((c // 4) ^ (row // 4 % 2)) * 4 + c % 4
            assert got[row, want_at] == steps[row, c]
    assert torch.equal(fused._swizzle32(got), steps)


def test_steps_give_the_layer_products(case):
    """Untruncated, hi + lo of the steps against the activations in the
    same order give the layer's float32 product: the layout, the
    permutation and the skip layer's two segments line up."""
    tp, x, _, _, _ = case
    (w1, _), (w2, _), (w3, _), _, _ = [(w.numpy(), b) for w, b in
                                       fused._layers(tp, torch.float32)]
    layers, image = fused._kernel_net(tp, torch.float32)
    image = fused._swizzle32(image)
    xs = -(-x.shape[1] // 32) * 4
    imgs = layer_images(image.numpy(), (256, 256, 256, 384, 384),
                        (xs, 32, 32 + xs, 32, 48))
    h = np.random.default_rng(6).random((R, 256), dtype=np.float32)
    for segments, w, (hi, lo) in (([x], w1, imgs[0]), ([h, x], w3, imgs[2])):
        a = as_steps(np.concatenate([pad32(s) for s in segments], axis=1))
        got = a.reshape(R, -1).astype(np.float64) @ (
            (hi.astype(np.float64) + lo).transpose(1, 0, 2).reshape(hi.shape[1], -1).T)
        want = np.concatenate(segments, axis=1).astype(np.float64) @ w
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


def test_three_product_chain_holds_the_kernels_tolerance(case):
    tp, x, qs, valid, want = case
    got = kernel_scores(tp, x, qs, valid, products=3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * valid.sum() / R)
    assert _max_rel(got, want) <= MAX_REL


def test_one_tf32_product_misses_the_kernels_tolerance(case):
    tp, x, qs, valid, want = case
    one = kernel_scores(tp, x, qs, valid, products=1)
    assert _max_rel(one, want) > MAX_REL
    # the split is closer to the reference than one product by orders
    three = kernel_scores(tp, x, qs, valid, products=3)
    assert np.abs(three - want).max() * 10 < np.abs(one - want).max()
