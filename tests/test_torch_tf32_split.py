"""The float32 route of the banked-scoring kernel computes its logits on
TF32 tensor cores, split in three: hi = x rounded to TF32 (10 mantissa
bits, to nearest), lo = x - hi (read by the tensor cores truncated to 10
bits), and K . q ~ hi_K . lo_q + lo_K . hi_q + hi_K . hi_q. This emulates
that arithmetic in numpy and holds the scores it gives to the JAX
package's Pallas kernel (interpret mode, float32) at the kernel's
tolerance; one TF32 product alone misses it, which shows that the check
can fail. The kernel itself is held to its plain version on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iffnerf_tpu.ops.banked_attention import banked_scores_fused as jbanked
from iffnerf_tpu_torch.ops.banked_attention import softmax_scores

R, D, P = 2048, 384, 256
RTOL = 2e-5   # the kernel's own tolerance against float32 scores


def tf32_round(x):
    """To nearest TF32, ties away from zero (cvt.rna.tf32.f32)."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_truncate(x):
    """The top 19 bits of a float32, as the tensor cores read an operand."""
    return (x.astype(np.float32).view(np.uint32)
            & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_product(a, b):
    """a [M, K] . b [N, K]^T of TF32 operands: each product is exact in
    float32 (11 x 11 significant bits), summed here in float64 and
    rounded once, which keeps the split's error apart from the order in
    which the tensor cores add."""
    a, b = tf32_truncate(a), tf32_truncate(b)
    return (a.astype(np.float64) @ b.astype(np.float64).T).astype(np.float32)


def split_logits(bank, q, products):
    hk, hq = tf32_round(bank), tf32_round(q)
    if products == 1:
        return tf32_product(hk, hq)
    lk, lq = bank - hk, q - hq
    return (tf32_product(hk, lq) + tf32_product(lk, hq)) + tf32_product(hk, hq)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(7)
    bank = rng.standard_normal((R, D), dtype=np.float32)
    q = rng.standard_normal((P, D), dtype=np.float32)
    valid = rng.random(P) > 1 / 3          # about a third invalid
    want = np.asarray(jbanked(jnp.asarray(bank), jnp.asarray(q),
                              jnp.asarray(valid), tile=256, interpret=True))
    return bank, q, valid, want


def _scores(bank, q, valid, products):
    logits = split_logits(bank, q, products) * np.float32(1 / math.sqrt(D))
    return softmax_scores(torch.from_numpy(logits),
                          torch.from_numpy(valid)).numpy()


def test_rounding_keeps_ten_mantissa_bits():
    x = np.array([1 + 2 ** -10, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                  1 + 2 ** -11 - 2 ** -23], np.float32)
    np.testing.assert_array_equal(
        tf32_round(x),
        np.array([1 + 2 ** -10, 1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10), 1],
                 np.float32))
    np.testing.assert_array_equal(tf32_truncate(np.float32(1 + 2 ** -10 + 2 ** -11)),
                                  np.float32(1 + 2 ** -10))


def test_three_product_split_holds_the_kernels_tolerance(case):
    bank, q, valid, want = case
    got = _scores(bank, q, valid, products=3)
    atol = RTOL * valid.sum() / R
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


def test_one_tf32_product_misses_the_kernels_tolerance(case):
    bank, q, valid, want = case
    got = _scores(bank, q, valid, products=1)
    atol = RTOL * valid.sum() / R
    assert not np.allclose(got, want, rtol=RTOL, atol=atol)
    # the split is closer to the reference than one product by orders
    split = _scores(bank, q, valid, products=3)
    assert (np.abs(split - want).max() * 100 < np.abs(got - want).max())
