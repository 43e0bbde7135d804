"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where no card is present, and run on one with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py``
(``--noconftest``: the suite's conftest imports JAX, which the card's
machine need not have). Ray counts cover one ray, a ragged tile, several
blocks and more tiles than blocks; the row gather covers the field's row
widths, ragged and empty index counts, the edge indices and a table whose
rows are not 16-byte aligned.
"""

import pytest
import torch

from iffnerf_tpu_torch.ops.banked_attention import (
    banked_scores_fused,
    banked_scores_plain,
)
from iffnerf_tpu_torch.ops.fused_ray_attention import (
    fused_ray_scores,
    fused_ray_scores_plain,
)
from iffnerf_tpu_torch.ops.gather import gather_rows, gather_rows_plain
from iffnerf_tpu_torch.pose.id_module import IDConfig, init_id_module

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _valid(dev):
    v = torch.zeros(256, dtype=torch.bool, device=dev)
    v[40:200] = True
    return v


def _assert_scores_close(got, want, rtol):
    """Scores held to ``rtol`` and an atol of rtol times the mean score:
    the scores of R rays sum to the valid patch count (160), so a fixed
    atol would let the many small scores of a large R pass unchecked."""
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=rtol * 160 / got.shape[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [1, 65, 1021, 70001])
def test_banked_kernel_matches_plain(dev, dtype, r):
    g = torch.Generator().manual_seed(r)
    bank = torch.randn((r, 384), generator=g).to(dev, dtype)
    q = torch.randn((256, 384), generator=g).to(dev, dtype)
    got = banked_scores_fused(bank, q, _valid(dev))
    torch.cuda.synchronize()
    want = banked_scores_plain(bank, q, _valid(dev))
    # float32 accumulation in another order (tests/test_banked_pose.py)
    _assert_scores_close(got, want, rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r", [1, 65, 1021, 70001])
def test_fused_kernel_matches_plain(dev, dtype, r):
    cfg = IDConfig(compute_dtype=dtype)
    params = init_id_module(torch.Generator().manual_seed(0), cfg, device=dev)
    g = torch.Generator().manual_seed(r)
    x = torch.randn((r, cfg.ray_in_dim), generator=g).to(dev, cfg.dtype)
    q = torch.randn((256, 384), generator=g).to(dev, cfg.dtype)
    got = fused_ray_scores(params, q, _valid(dev), x)
    torch.cuda.synchronize()
    want = fused_ray_scores_plain(params, q, _valid(dev), x)
    # float32 summation order; bf16 activations may round differently,
    # which moves a score by well under 1e-3 of itself
    _assert_scores_close(got, want, rtol=1e-5 if dtype == "float32" else 1e-3)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("r,c", [(90000, 256), (90000, 48), (90000, 16),
                                 (300, 48), (300 ** 3, 1), (1000, 3)])
@pytest.mark.parametrize("n", [0, 1, 1021, 204660])
def test_gather_kernel_matches_plain(dev, r, c, n, aligned):
    """Exact: rows are copied, never computed. The first indices are the
    edges R - 1, R and -R - 1 (NaN rows), -1 and -R (wrapped)."""
    g = torch.Generator().manual_seed(r + c + n)
    # one float of offset puts every row off the 16-byte grid: scalar path
    buf = torch.randn((r * c + 1,), generator=g).to(dev)
    table = (buf[:-1] if aligned else buf[1:]).view(r, c)
    idx = torch.randint(0, r, (n,), generator=g, dtype=torch.int32)
    idx[:5] = torch.tensor([r - 1, r, -1, -r, -r - 1], dtype=torch.int32)[:n]
    idx = idx.to(dev)
    got = gather_rows(table, idx)
    torch.cuda.synchronize()
    want = gather_rows_plain(table, idx)
    assert got.shape == (n, c)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
