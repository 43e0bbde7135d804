"""The bf16 route of the fused ray-scoring kernel streams each layer's
weights through a ring of shared memory as the B operand of bf16 ``wgmma``,
cut into steps of 16 deep: each step is the N rows of w^T for that depth,
laid out by the wrapper as shared memory holds them (rows of 32 bytes with
the 32-byte swizzle), once per set of parameters (``_kernel_net``), and the
queries so for each call. The activations are the A operand, bf16 in
shared memory; each layer sums in float32, adds the bias, applies its ReLU
and rounds to bf16.

This checks those layouts against the weights bit for bit, and emulates
the kernel's chain from them in numpy: float32 sums over the kernel's
k-order (each step's 16 products exact, then added to the sum), bf16
rounding after each layer. Its scores are held to the plain version and
to the JAX package's Pallas kernel (interpret mode, bf16) at the kernel's
tolerance. It also holds the wrapper's copy of the kernel's shared-memory
plan. The kernel itself is held to its plain version on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py).
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
RTOL = 1e-3      # the bf16 kernel's tolerance against its plain version
BF = torch.bfloat16
STAGE = fused._BF16_STEP * fused._BF16_STAGE_STEPS   # depth of a ring stage: 64


def to_bf16(a):
    """float32 numpy -> the nearest bf16 values (to nearest, ties to even),
    as float32 numpy."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF).float().numpy()


def layer_steps(image, widths, steps):
    """The net's step image [rows, 16] cut into each layer's steps,
    [steps, N, 16] each."""
    out, row = [], 0
    for n, s in zip(widths, steps):
        out.append(image[row:row + s * n].reshape(s, n, 16))
        row += s * n
    assert row == image.shape[0]
    return out


def as_wt(steps):
    """Steps [S, N, 16] -> w^T [N, 16 S] in the kernel's depth order."""
    return steps.transpose(1, 0, 2).reshape(steps.shape[1], -1)


def pad_to(a, depth):
    """Zero columns up to a multiple of ``depth``."""
    return np.pad(a, ((0, 0), (0, -a.shape[1] % depth)))


def kernel_layer(segments, steps):
    """The float32 sums of one layer over its input ``segments`` (each
    padded to whole stages) as the kernel forms them: step by step, each
    step's 16 products exact and added to the sum once."""
    a = np.concatenate([pad_to(s, STAGE) for s in segments], axis=1).astype(np.float64)
    acc = np.zeros((a.shape[0], steps.shape[1]), np.float32)
    for k in range(steps.shape[0]):
        part = a[:, 16 * k:16 * k + 16] @ steps[k].astype(np.float64).T
        acc = (acc + part).astype(np.float32)
    return acc


def net_steps(tp):
    layers, image = fused._kernel_net(tp, BF)
    image = fused._swizzle32(image).float().numpy()     # unswizzled
    (w1, _), (w2, _), (w3, _), (w4, _), (wk, _) = layers
    h1, h2, h3, dk = w1.shape[1], w2.shape[1], w3.shape[1], w4.shape[1]
    xs = -(-w1.shape[0] // STAGE) * (STAGE // 16)
    return layers, layer_steps(image, (h1, h2, h3, dk, dk),
                               (xs, h1 // 16, h2 // 16 + xs, h3 // 16, dk // 16))


def kernel_scores(tp, x, qs, valid):
    """The bf16 kernel's scores, emulated from the wrapper's layouts."""
    layers, steps = net_steps(tp)
    bias = [b.float().numpy() for _, b in layers]
    q_steps = fused._bf16_steps([torch.from_numpy(qs).to(BF)]).float().numpy()
    q_steps = q_steps.reshape(-1, qs.shape[1], 16)

    def layer(segments, i, relu):
        y = kernel_layer(segments, steps[i]) + bias[i]
        return to_bf16(np.maximum(y, 0) if relu else y)

    h = layer([x], 0, True)
    h = layer([h], 1, True)
    h = layer([h, x], 2, True)
    h = layer([h], 3, False)
    k = layer([h], 4, False)
    logits = kernel_layer([k], q_steps)
    return softmax_scores(torch.from_numpy(logits), torch.from_numpy(valid)).numpy()


@pytest.fixture(scope="module")
def case():
    """The JAX package's initial ID module, 2048 candidate rays through
    ray_mlp_inputs in bf16, N(0, 1) queries in bf16 and about 30 % of the
    patches invalid; the Pallas kernel's scores on them."""
    jcfg, tcfg = configs(compute_dtype="bfloat16")
    jp, tp = params(37, jcfg)
    s = scene(37, R)
    rays = [torch.from_numpy(s[k]) for k in ("rays_ori", "rays_dirs", "rays_rgb")]
    x = tid.ray_mlp_inputs(tcfg, *rays)
    assert x.dtype == BF
    rng = np.random.default_rng(37)
    q = torch.from_numpy(rng.standard_normal((256, 384), dtype=np.float32)).to(BF)
    valid = rng.random(256) > 0.3
    want = np.asarray(jfused(jp, jnp.asarray(q.float().numpy(), jnp.bfloat16),
                             jnp.asarray(valid),
                             jnp.asarray(x.float().numpy(), jnp.bfloat16),
                             tile=256, interpret=True))
    qs = fused.scaled_queries(q, BF).float().numpy()
    return tp, x, q, qs, valid, want


def test_bf16_steps_give_back_each_layers_weights(case):
    """Unswizzled, each layer's steps are its w^T bit for bit, each input
    segment zero-padded to whole stages of 64 deep: x 141 -> 192, and the
    skip layer's h2 rows then its x rows. The queries' steps are qs^T."""
    tp, _, _, qs, _, _ = case
    layers, steps = net_steps(tp)
    (w1, _), (w2, _), (w3, _), (w4, _), (wk, _) = [
        (w.float().numpy(), b) for w, b in layers]
    h2 = w2.shape[1]
    want = [pad_to(w1.T, STAGE), w2.T, np.concatenate(
        [w3[:h2].T, pad_to(w3[h2:].T, STAGE)], axis=1), w4.T, wk.T]
    assert want[0].shape == (256, 192) and want[2].shape == (256, 448)
    for got, w in zip(steps, want):
        np.testing.assert_array_equal(as_wt(got), w)
    q_image = fused._bf16_steps([torch.from_numpy(qs).to(BF)]).float().numpy()
    np.testing.assert_array_equal(as_wt(q_image.reshape(-1, 256, 16)), qs.T)


def test_bf16_swizzle_swaps_the_halves_of_rows_4_to_7_of_each_atom():
    """Byte (row, b) of a 32-byte-swizzled tile lies at row * 32 +
    ((b // 16) ^ (row // 4 % 2)) * 16 + b % 16 (csrc/tma_wgmma.cuh): for
    rows of 16 bf16, element c at ((c // 8) ^ (row // 4 % 2)) * 8 + c % 8."""
    steps = torch.arange(64 * 16, dtype=torch.float32).reshape(64, 16).to(BF)
    got = fused._swizzle32(steps)
    for row in range(64):
        for c in range(16):
            assert got[row, ((c // 8) ^ (row // 4 % 2)) * 8 + c % 8] == steps[row, c]
    assert torch.equal(fused._swizzle32(got), steps)


def test_bf16_chain_holds_the_kernels_tolerance(case):
    """The emulated kernel against the plain version and the Pallas kernel:
    rtol 1e-3 (a bf16 rounding of an activation may flip with the order of
    a float32 sum) and an atol of rtol times the mean score; the same
    top-32 rays."""
    tp, x, q, qs, valid, want = case
    got = kernel_scores(tp, x.float().numpy(), qs, valid)
    plain = fused.fused_ray_scores_plain(tp, q, torch.from_numpy(valid), x).numpy()
    atol = RTOL * valid.sum() / R
    np.testing.assert_allclose(got, plain, rtol=RTOL, atol=atol)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)
    top = lambda s: set(np.argsort(-s, kind="stable")[:32].tolist())
    assert top(got) == top(want)


@pytest.mark.parametrize("n", fused.BF16_WIDTHS)
def test_bf16_plan_leaves_two_stages_at_every_width(n):
    """Every width the bf16 route takes, with every D, leaves at least two
    ring stages beside its activations; at the model's widths the
    activations take 7 chunks (56 KB) and leave 3 stages of 48 KB."""
    for d in fused.BF16_WIDTHS:
        widths = (141, n, n, n, d)
        assert fused.bf16_stages(widths) >= 2
        assert fused.kernel_takes(BF, 256, widths)
    assert fused.bf16_stages((141, 256, 256, 256, 384)) == 3


@pytest.mark.parametrize("in_dim,stages", [(256, 2), (320, 1)])
def test_bf16_kernel_takes_needs_two_stages(in_dim, stages):
    """At width 512 an input of 256 (x in chunks 8-11 beside the 8 of the
    h buffer) leaves two stages of 64 KB and is taken; 320 (13 chunks)
    leaves one and is refused, so the callers score it on the exact
    path."""
    widths = (in_dim, 512, 512, 512, 512)
    assert fused.bf16_stages(widths) == stages
    assert fused.kernel_takes(BF, 256, widths) is (stages >= 2)
