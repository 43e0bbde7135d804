"""Port parity for the ray side and the scoring: ray_bank, the exact
score_rays, and the plain versions of the two kernels against the JAX
package's Pallas kernels run in interpret mode on the CPU. Both sides get
the same numpy inputs; the kernels themselves are held to these plain
versions on the card by chip_smoke.py and tests/test_torch_cuda_kernels.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iffnerf_tpu.ops.banked_attention import banked_scores_fused as jbanked
from iffnerf_tpu.ops.fused_ray_attention import fused_ray_scores as jfused
from iffnerf_tpu.pose import id_module as jid
from iffnerf_tpu_torch.ops.banked_attention import (
    banked_scores_fused,
    banked_scores_plain,
)
from iffnerf_tpu_torch.ops.fused_ray_attention import (
    _kernel_net,
    _swizzle32,
    fused_ray_scores_plain,
)
from iffnerf_tpu_torch.ops.topk import exact_topk
from iffnerf_tpu_torch.pose import id_module as tid

from torch_parity import configs, f32, params, replace, scene, t

N_RAYS = 2048


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    jp, tp = params(23, jcfg)
    return jcfg, tcfg, jp, tp, scene(23, N_RAYS)


def _rays(s, conv):
    return conv(s["rays_ori"]), conv(s["rays_dirs"]), conv(s["rays_rgb"])


def _jax_side(setup, dtype):
    """JAX q, patch_valid, bank, x in ``dtype``, plus the same as tensors."""
    jcfg, tcfg, jp, tp, s = setup
    jcfg = replace(jcfg, compute_dtype=dtype)
    q, pv, _ = jid.image_queries(jp, jcfg, jnp.asarray(s["img"]),
                                 jnp.asarray(s["mask"]))
    rays = _rays(s, jnp.asarray)
    bank = jid.ray_bank(jp, jcfg, *rays)
    x = jid.ray_mlp_inputs(jcfg, *rays)
    return (jcfg, q, pv, bank, x), (t(q), t(pv), t(bank), t(x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ray_bank_matches(setup, dtype):
    jcfg, tcfg, jp, tp, s = setup
    want = jid.ray_bank(jp, replace(jcfg, compute_dtype=dtype),
                        *_rays(s, jnp.asarray))
    got = tid.ray_bank(tp, replace(tcfg, compute_dtype=dtype),
                       *_rays(s, lambda a: a), device="cpu")
    assert got.dtype == getattr(torch, dtype) and got.shape == (N_RAYS, 384)
    if dtype == "float32":
        # Five float32 layers summed in another order. XLA and ATen split
        # their dot products by the host's threads and vector width, so the
        # order also moves between machines (JAX eager against jit alone
        # moved an element by 3.9e-7). Each element is held to 1e-5 of
        # itself plus the first-order bound of reordering its last dot
        # product, 2 K 2^-24 sum_k |h_k w_k| for both sides (K = 384).
        h = tid.ray_features(tp, tcfg, *_rays(s, torch.from_numpy)).double()
        w = tp["k_proj"]["w"].double()
        reorder = 2 * w.shape[0] * 2.0 ** -24 * (h.abs() @ w.abs()).numpy()
        err = np.abs(f32(got).astype(np.float64) - f32(want))
        tol = 1e-5 + 1e-5 * np.abs(f32(want)) + reorder
        assert (err <= tol).all(), (err - tol).max()
    else:
        # the same bf16 rounding points; a reduction-order flip of one
        # rounding moves an element by about one bf16 ulp (2^-8 relative)
        np.testing.assert_allclose(f32(got), f32(want), rtol=1e-2, atol=2e-3)
        assert (f32(got) != f32(want)).mean() < 0.01


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_score_rays_matches(setup, dtype):
    (jcfg, q, pv, bank, _), (tq, tpv, tbank, _) = _jax_side(setup, dtype)
    tcfg = replace(setup[1], compute_dtype=dtype, fused_bank=False)
    want, watt = jid.score_rays(None, replace(jcfg, fused_bank=False), q, pv,
                                None, None, None, bank=bank)
    got, att = tid.score_rays(None, tcfg, tq, tpv, None, None, None,
                              bank=tbank)
    # float32 logits and softmax over the same inputs: summation order
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(f32(att), f32(watt), rtol=2e-5, atol=1e-8)


@pytest.mark.parametrize("dtype,valid", [
    ("float32", "blob"), ("bfloat16", "blob"),
    ("float32", "none"), ("bfloat16", "none"),
])
def test_banked_plain_matches_pallas(setup, dtype, valid):
    """The banked kernel's plain version against the two Pallas kernels
    (interpret mode, 8 tiles of 256 rays, so the running statistics rescale
    between tiles)."""
    (_, q, pv, bank, _), (tq, tpv, tbank, _) = _jax_side(setup, dtype)
    if valid == "none":
        pv, tpv = jnp.zeros_like(pv), torch.zeros_like(tpv)
    else:
        assert 0 < int(tpv.sum()) < 256
    want = jbanked(bank, q, pv, tile=256, interpret=True)
    got = banked_scores_plain(tbank, tq, tpv)
    assert got.dtype == torch.float32
    # tolerances of tests/test_banked_pose.py: float32 reduction order
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-5, atol=2e-6)
    if valid == "none":
        assert not got.any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_plain_matches_pallas(setup, dtype):
    """The fused ray-scoring kernel's plain version against the Pallas
    kernel (interpret mode, 8 tiles of 256 rays)."""
    (jcfg, q, pv, _, x), (tq, tpv, _, tx) = _jax_side(setup, dtype)
    _, _, jp, tp, _ = setup
    want = jfused(jp, q, pv, x, tile=256, interpret=True)
    got = fused_ray_scores_plain(tp, tq, tpv, tx)
    # rtol as the card holds the kernel to this plain version (bf16
    # rounding flips of the activations set the bf16 one; 5.7e-5 at these
    # shapes on a CPU), atol rtol times the mean score: the scores of R
    # rays sum to the valid patch count, so no score passes on atol alone
    rtol = 1e-5 if dtype == "float32" else 1e-3
    atol = rtol * int(tpv.sum()) / N_RAYS
    np.testing.assert_allclose(f32(got), f32(want), rtol=rtol, atol=atol)
    _, i_got = exact_topk(got, 32)
    _, i_want = exact_topk(t(want), 32)
    assert set(i_got.tolist()) == set(i_want.tolist())


def test_bf16_kernel_weight_layout(setup):
    """The steps that the fused kernel's bf16 route streams (16 deep, the N
    rows of w^T each, as shared memory holds them) give the plain layers'
    products against the activations in the same depth order: x padded
    with zeros to whole ring stages of 64 deep (141 -> 192), and the skip
    layer's steps the h2 rows, then the x rows, as the kernel reads
    [h2 | x] from its chunks."""
    _, tcfg, _, tp, s = setup
    x = tid.ray_mlp_inputs(tcfg, *_rays(s, t)).to(torch.bfloat16).float()
    layers, steps = _kernel_net(tp, torch.bfloat16)
    steps = _swizzle32(steps).float()          # unswizzled: [rows, 16]
    (w1, _), (w2, _), (w3, _), _, _ = layers
    in_dim, n = x.shape[1], w1.shape[1]
    xs = -(-in_dim // 64) * 4                  # steps of x: 12
    l1, _, l3 = torch.split(steps[:(2 * xs + 32) * n],
                            [xs * n, 16 * n, (16 + xs) * n])

    def product(a, image):   # the steps' rows as w^T [N, K'], then a w
        return a @ image.reshape(-1, n, 16).transpose(0, 1).reshape(n, -1).T

    xp = torch.nn.functional.pad(x, (0, 16 * xs - in_dim))
    h = torch.from_numpy(np.random.default_rng(3).random(
        (x.shape[0], w2.shape[1]), dtype=np.float32)).to(torch.bfloat16).float()
    # the same float32 sums plus zero terms, in another blocking
    torch.testing.assert_close(product(xp, l1), x @ w1.float(),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(product(torch.cat([h, xp], -1), l3),
                               torch.cat([h, x], -1) @ w3.float(),
                               rtol=1e-5, atol=1e-5)


def test_fused_kernel_net_built_once_per_params(setup):
    """The kernel's weight steps (bf16: 16 deep; float32: the TF32-split
    8-deep steps) are built once for a set of parameter tensors and a
    dtype, reused while the same tensors come back (each dtype keeps its
    own entry, so routes that alternate reuse both), and rebuilt for other
    tensors or after an in-place update."""
    tp = setup[3]
    net = _kernel_net(tp, torch.bfloat16)
    assert _kernel_net(tp, torch.bfloat16) is net
    net32 = _kernel_net(tp, torch.float32)
    assert _kernel_net(tp, torch.float32) is net32
    assert net32[1].dtype == torch.float32 and net32[1].shape[1] == 8
    assert net[1].dtype == torch.bfloat16 and net[1].shape[1] == 16
    for _ in range(2):   # alternating dtypes rebuilds neither
        assert _kernel_net(tp, torch.bfloat16) is net
        assert _kernel_net(tp, torch.float32) is net32

    def clone(layer):
        return {k: v.clone() for k, v in layer.items()}

    mine = {"ray_mlp": [clone(l) for l in tp["ray_mlp"]],
            "ray_mlp2": [clone(l) for l in tp["ray_mlp2"]],
            "k_proj": clone(tp["k_proj"])}
    _, st = _kernel_net(mine, torch.bfloat16)
    assert st is not net[1]
    torch.testing.assert_close(st, net[1], rtol=0, atol=0)   # the same values
    steps = _kernel_net(mine, torch.float32)[1]
    torch.testing.assert_close(steps, net32[1], rtol=0, atol=0)
    mine["k_proj"]["w"].mul_(2)
    # doubling is exact in bf16, and in both halves of the TF32 split; the
    # k projection's steps come last, in whole swizzle atoms
    st2 = _kernel_net(mine, torch.bfloat16)[1]
    k16 = 384 // 16 * 384
    torch.testing.assert_close(st2[-k16:].float(), 2 * st[-k16:].float(),
                               rtol=0, atol=0)
    torch.testing.assert_close(st2[:-k16], st[:-k16], rtol=0, atol=0)
    steps2 = _kernel_net(mine, torch.float32)[1]
    k_rows = 384 // 8 * 2 * 384
    torch.testing.assert_close(steps2[-k_rows:], 2 * steps[-k_rows:], rtol=0,
                               atol=0)
    torch.testing.assert_close(steps2[:-k_rows], steps[:-k_rows], rtol=0,
                               atol=0)
    bad = dict(mine, k_proj={"w": torch.zeros(384, 200),
                             "b": torch.zeros(200)})
    with pytest.raises(ValueError, match="do not chain"):
        _kernel_net(bad, torch.bfloat16)


def test_banked_dispatch_on_cpu(setup):
    """With a bank and fused_bank (the default), score_rays takes the
    banked kernel's wrapper, which takes the plain version for CPU
    tensors; fused_bank=False keeps the exact path and its attention."""
    _, (tq, tpv, tbank, _) = _jax_side(setup, "float32")
    tcfg = setup[1]
    before = banked_scores_fused.launches
    scores, att = tid.score_rays(None, tcfg, tq, tpv, None, None, None,
                                 bank=tbank)
    assert att is None and banked_scores_fused.launches == before
    exact, att2 = tid.score_rays(None, replace(tcfg, fused_bank=False), tq,
                                 tpv, None, None, None, bank=tbank)
    assert att2 is not None
    torch.testing.assert_close(scores, exact, rtol=2e-5, atol=2e-6)


def test_test_image_matches(setup):
    jcfg, tcfg, jp, tp, s = setup
    want = jid.test_image(jp, jcfg, jnp.asarray(s["img"]),
                          jnp.asarray(s["mask"]), *_rays(s, jnp.asarray),
                          rays_to_output=32)
    got = tid.test_image(tp, tcfg, t(s["img"]), t(s["mask"]),
                         *_rays(s, t), rays_to_output=32)
    assert set(got[0].tolist()) == set(np.asarray(want[0]).tolist())
    # float32 chain end to end: 2e-5
    np.testing.assert_allclose(f32(got[2]), f32(want[2]), rtol=2e-5, atol=2e-6)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


def test_distance_based_score_loss_matches(setup):
    s = setup[4]
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.5, -1.0, 2.0]
    pred = np.random.default_rng(9).random(N_RAYS).astype(np.float32)
    want = jid.distance_based_score_loss(
        jnp.asarray(pred), jnp.asarray(pose), jnp.asarray(s["rays_ori"]),
        jnp.asarray(s["rays_dirs"]), 256)
    got = tid.distance_based_score_loss(
        t(pred), t(pose), t(s["rays_ori"]), t(s["rays_dirs"]), 256)
    for a, b in zip(got, want):
        np.testing.assert_allclose(f32(a), f32(b), rtol=1e-5, atol=1e-6)
