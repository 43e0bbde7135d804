"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where no card is present, and run on one with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py``
(``--noconftest``: the suite's conftest imports JAX, which the card's
machine need not have). Ray counts of the banked scorer cover one ray,
the edges of its 64-ray tile and of its 2-CTA pair, fewer tiles than SMs,
more tiles than two an SM and the main path's 540 000, and its float32
route also the depths 32, 64 and 128; both routes are held to bit-equal
repeats, zeros for an all-invalid mask and the refusal of depths they do
not take, and ``score_rays`` to the exact path's scores, with no launch,
for the shapes the kernel refuses. The fused ray scorer's float32 route
covers one ray to the main path's 540 000 within rtol 1e-5 and a largest
relative error of 5e-6, bit-equal repeats, an all-invalid mask and a
width it refuses; its bf16 route bit-equal repeats, all-invalid masks,
layer widths 128 and 512, a width it refuses and an x it cannot copy. The scoring kernels raise under grad
(they have no backward) and run under ``torch.no_grad()``; the row gather
and ``field_features`` under grad launch their forward and their backward
kernel, and their gradients are held to ``index_add_``'s and to autograd's
through the grid samplers. The TensorCP kernels (``ops/cp_features.py``:
forward, line gradient, coordinate gradient) are held to their plain
versions at 0 to 1021 samples and at a lego CP step's 7.1 M (the plain
version chunked), at ranks 1, 5, 47, 96 and 288, on uneven lines and on
samples beyond [-1, 1] (products bit-equal, gradients within CP_GRAD_TOL
and COORDS_GRAD_TOL), and refuse what they do not take before any launch;
the line gradient also at counts around its stage and unit lengths, with
dead stages and units, ranks that are not multiples of 4 and slices that
hold both kinds, density-only and appearance-only, and at the lines'
length where its plan narrows the columns a block; the coordinate
gradient also at an iteration-like set (about 3 % of the samples live in
a run along each ray) and an all-live set, each in three bit-equal calls,
with live samples only at the ends of its stages, units and call, live
through dsigma alone or one dapp word alone, with zero upstream giving
exact zeros, at lego's ranks on 4-byte words in four passes (coordinates
or dapp off the 16-byte grid), and at appearance ranks wide enough for
4-sample stages or past its plan (refused before any launch);
K3's backward is held to ``index_add_`` at the mask lookup's, the lines'
and a VM plane's shapes, a line of 2 500 rows, one run, runs of 1, one
entry and less than a unit; the samplers' route of a VM and a CP field under grad
(``fused_eval="off"``) runs on it. The row gather covers both its routes,
the field's row widths, ragged and empty index counts, the edge indices, a table whose
rows are not 16-byte aligned and the mask lookup's stacked corners; the
fused field kernel covers lego's widths and non-cubic grids with unequal
ranks (float4 and 4-byte words), empty to colour-chunk sample counts, in
its density-only and appearance modes, on scattered points and on
ray-ordered samples (app products bit-equal, unaligned tables and
coordinates too), and so does its backward kernel
(``field_features_backward``, float4 and scalar atomics) against
``field_features_backward_plain``, on scattered points and on ray-ordered
samples (rays along the axes and the diagonals at half-texel steps, runs
that cross ray ends and hold stretches of zero upstream, sample counts at
the edges of the kernel's run length). Its coordinate-gradient kernel
(``field_features_coords_grad``, iNeRF's) is held to
``field_features_coords_grad_plain`` on the same fields at scattered
points, texel boundaries and ray-ordered samples, aligned and not, zero
upstream giving zeros, and under autograd beside the table backward; its
walk on ray-ordered samples half a texel and a texel apart, at sample
counts around its run and stage lengths (the last stage read from global
memory) and an odd count, with dead samples inside runs, whole dead runs
and samples whose density or appearance upstream alone is zero, density
only and with appearance, at every field's ranks (flower's 16/4/4 and
48/12/12 among them), in bit-equal repeats. Repair's ranks 16/16/4 and
48/48/12 on its 377x377x188 grid are among the fields; the three field
kernels are also held at unisphere samples that reach beyond [-1, 1], and
the density-only forward on chunks of a dense alpha lattice.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from iffnerf_tpu_torch.models.field import (
    FieldConfig,
    compute_features,
    init_field,
)
from iffnerf_tpu_torch.ops import grid_sample as grid_sample_module
from iffnerf_tpu_torch.ops.banked_attention import (
    banked_scores_fused,
    banked_scores_plain,
)
from iffnerf_tpu_torch.ops.fused_ray_attention import (
    fused_ray_scores,
    fused_ray_scores_plain,
)
from iffnerf_tpu_torch.ops.field_features import (
    MAT_MODE,
    TABLES,
    VEC_MODE,
    field_features,
    field_features_backward,
    field_features_backward_plain,
    field_features_coords_grad,
    field_features_coords_grad_plain,
    field_features_plain,
)
from iffnerf_tpu_torch.ops import cp_features as cpf
from iffnerf_tpu_torch.ops.gather import (
    backward_plan,
    gather_rows,
    gather_rows_backward,
    gather_rows_backward_plain,
    gather_rows_plain,
)
from iffnerf_tpu_torch.ops.grid_sample import (
    corners_1d,
    corners_2d,
    corners_3d,
    grid_sample_1d,
    grid_sample_2d,
    grid_sample_3d,
)
from iffnerf_tpu_torch.pose.id_module import IDConfig, init_id_module, score_rays
from iffnerf_tpu_torch.pose.solve import _scores_maybe_fused
from iffnerf_tpu_torch.pose.vit import ViTConfig
from iffnerf_tpu_torch.tools.cp_time import iteration_upstream
from iffnerf_tpu_torch.tools.ff_time import (
    AXES,
    DIAGONALS,
    ray_ordered_samples,
    ray_upstream,
    run_samples,
)

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


def _bank_and_queries(dev, dtype, r, d=384):
    g = torch.Generator().manual_seed(r)
    bank = torch.randn((r, d), generator=g).to(dev, dtype)
    q = torch.randn((256, d), generator=g).to(dev, dtype)
    return bank, q


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [1, 63, 64, 65, 127, 128, 129, 1021, 4000,
                               70001, 540000])
def test_banked_kernel_matches_plain(dev, dtype, r):
    """64-ray tiles dealt over 2-CTA clusters (one a pair of SMs): the
    tile's and the pair's edges, 63 tiles (fewer than SMs), 1094 (more
    than two an SM), the main path's 540 000 rays."""
    bank, q = _bank_and_queries(dev, dtype, r)
    got = banked_scores_fused(bank, q, _valid(dev))
    torch.cuda.synchronize()
    want = banked_scores_plain(bank, q, _valid(dev))
    # float32 accumulation in another order (tests/test_banked_pose.py)
    _assert_scores_close(got, want, rtol=2e-5)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("r", [1, 63, 64, 65, 127, 128, 129, 1021, 4000,
                               70001, 540000])
def test_banked_kernel_matches_plain_at_float32_depths(dev, d, r):
    """The float32 route's depths below 384: one to four 32-deep chunks a
    tile, so a tile's chunks fill its ring once or wrap round it."""
    bank, q = _bank_and_queries(dev, torch.float32, r, d)
    got = banked_scores_fused(bank, q, _valid(dev))
    torch.cuda.synchronize()
    _assert_scores_close(got, banked_scores_plain(bank, q, _valid(dev)),
                         rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_banked_kernel_is_deterministic(dev, dtype):
    """bf16: each CTA of a pair adds its half of a ray's score onto zero,
    and the two orders give the same bits. float32: the four CTAs' shares
    are added in rank order."""
    bank, q = _bank_and_queries(dev, dtype, 540000)
    first = banked_scores_fused(bank, q, _valid(dev))
    assert torch.equal(first, banked_scores_fused(bank, q, _valid(dev)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [129, 70001])
def test_banked_kernel_all_invalid_mask_gives_zeros(dev, dtype, r):
    bank, q = _bank_and_queries(dev, dtype, r)
    none = torch.zeros(256, dtype=torch.bool, device=dev)
    assert not bool(banked_scores_fused(bank, q, none).any())


@pytest.mark.parametrize("d", [32, 96, 448])
def test_banked_kernel_refuses_bf16_depths_it_does_not_take(dev, d):
    """The bf16 route reads depth in TMA boxes of 64, up to 384."""
    bank, q = _bank_and_queries(dev, torch.bfloat16, 129, d)
    before = banked_scores_fused.launches
    with pytest.raises(ValueError, match="bank depth"):
        banked_scores_fused(bank, q, _valid(dev))
    assert banked_scores_fused.launches == before


@pytest.mark.parametrize("d", [16, 48, 416])
def test_banked_kernel_refuses_float32_depths_it_does_not_take(dev, d):
    """The float32 route reads depth in TMA boxes of 32, up to 384."""
    bank, q = _bank_and_queries(dev, torch.float32, 129, d)
    before = banked_scores_fused.launches
    with pytest.raises(ValueError, match="bank depth"):
        banked_scores_fused(bank, q, _valid(dev))
    assert banked_scores_fused.launches == before


def _grad_cases(dev):
    """(name, call) for each of the four ctypes-launched kernels, each with
    one input that requires grad."""
    g = torch.Generator().manual_seed(9)
    bank = torch.randn((129, 384), generator=g).to(dev).requires_grad_()
    q = torch.randn((256, 384), generator=g).to(dev)
    cfg = IDConfig()
    params = init_id_module(torch.Generator().manual_seed(0), cfg, device=dev)
    params["k_proj"]["w"].requires_grad_()
    x = torch.randn((65, cfg.ray_in_dim), generator=g).to(dev)
    table = torch.randn((300, 16), generator=g).to(dev).requires_grad_()
    idx = torch.randint(0, 300, (1021,), generator=g, dtype=torch.int32).to(dev)
    config, field = _field(FIELDS["non_cubic_scalar"], dev)
    field["app_line"][1].requires_grad_()
    xyz = (torch.rand((1021, 3), generator=g) * 2 - 1).to(dev)
    _grad_cases.field = (config, field, xyz)
    _grad_cases.gather = (table, idx)
    return {"banked_scores_fused": lambda: banked_scores_fused(bank, q, _valid(dev)),
            "fused_ray_scores": lambda: fused_ray_scores(params, q, _valid(dev), x),
            "gather_rows": lambda: gather_rows(table, idx),
            "field_features": lambda: field_features(config, field, xyz, True)}


@pytest.mark.parametrize("name", ["banked_scores_fused", "fused_ray_scores",
                                  "gather_rows", "field_features"])
def test_kernel_wrappers_refuse_grad_and_run_without_it(dev, name):
    """K1 and K2 have no backward: under grad with an input that requires
    it, each wrapper raises before any launch; under torch.no_grad() it
    runs. K3 and field_features have one: under grad each launches its
    forward once and, on backward, its backward kernel once, and the
    table's gradient is index_add_'s (K3) or autograd's through the grid
    samplers on plain gathers within FIELD_GRAD_TOL of its largest."""
    call = _grad_cases(dev)[name]
    counter = {"banked_scores_fused": banked_scores_fused,
               "fused_ray_scores": fused_ray_scores, "gather_rows": gather_rows,
               "field_features": field_features}[name]
    before = counter.launches
    if name == "field_features":
        back = field_features_backward.launches
        sigma, app = call()
        (sigma.sum() + app.square().sum()).backward()
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        assert field_features_backward.launches == back + 1
        config, field, xyz = _grad_cases.field
        leaf = field["app_line"][1]
        got = leaf.grad
        with torch.no_grad():
            _, want_app = field_features_plain(field, xyz, True,
                                               gather_rows_plain)
        want = field_features_backward_plain(
            field, xyz, torch.ones_like(sigma), 2 * want_app)["app_line"][1]
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=FIELD_GRAD_TOL * float(want.abs().max()))
        return
    if name == "gather_rows":
        back = gather_rows_backward.launches
        out = call()
        up = torch.linspace(-1, 1, out.numel(), device=dev).view_as(out)
        (out * up).sum().backward()
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        assert gather_rows_backward.launches == back + 1
        table, idx = _grad_cases.gather
        want = gather_rows_backward_plain(up, idx, table.shape[0])
        torch.testing.assert_close(table.grad, want, rtol=0,
                                   atol=CP_GRAD_TOL * float(want.abs().max()))
        return
    with pytest.raises(RuntimeError, match="no backward on CUDA"):
        call()
    assert counter.launches == before
    with torch.no_grad():
        out = call()
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert all(not t.requires_grad for t in
               (out if isinstance(out, tuple) else (out,)) if t is not None)


@pytest.fixture(scope="module")
def small_crop_params(dev):
    """A 112 crop (8 x 8 = 64 patches, which neither scoring kernel takes)."""
    cfg = IDConfig(resize_size=128, crop_size=112,
                   backbone=ViTConfig(img_size=112, depth=1))
    return cfg, init_id_module(torch.Generator().manual_seed(3), cfg, device=dev)


def _refused_bank_case(dev, which, small_crop_params):
    g = torch.Generator().manual_seed(11)
    if which == "p64":
        cfg, params = small_crop_params
        d, dtype = 384, torch.float32
    else:
        cfg, params = IDConfig(), None
        d, dtype = {"bf16_d96": (96, torch.bfloat16),
                    "f32_d48": (48, torch.float32)}[which]
    p = 64 if which == "p64" else 256
    bank = torch.randn((70001, d), generator=g).to(dev, dtype)
    q = torch.randn((p, d), generator=g).to(dev, dtype)
    valid = torch.rand(p, generator=g).to(dev) > 0.3
    return cfg, params, bank, q, valid


@pytest.mark.parametrize("which", ["p64", "bf16_d96", "f32_d48"])
def test_score_rays_sends_refused_banks_to_the_exact_path(
        dev, which, small_crop_params):
    """Shapes the banked kernel refuses (64 patches, a bf16 depth of 96, a
    float32 depth of 48) are scored on the exact path, as the JAX package
    falls back to XLA: the exact path's scores, and no launch."""
    cfg, params, bank, q, valid = _refused_bank_case(dev, which,
                                                     small_crop_params)
    before = banked_scores_fused.launches
    scores, att = score_rays(params, cfg, q, valid, None, None, None,
                             bank=bank)
    exact, _ = score_rays(params, dataclasses.replace(cfg, fused_bank=False),
                          q, valid, None, None, None, bank=bank)
    assert banked_scores_fused.launches == before
    assert att is not None and torch.equal(scores, exact)


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


def _fused_f32_case(dev, r):
    cfg = IDConfig()
    params = init_id_module(torch.Generator().manual_seed(0), cfg, device=dev)
    g = torch.Generator().manual_seed(r)
    x = torch.randn((r, cfg.ray_in_dim), generator=g).to(dev)
    q = torch.randn((256, 384), generator=g).to(dev)
    return params, x, q


@pytest.mark.parametrize("r", [1, 63, 64, 65, 1021, 540000])
def test_fused_f32_kernel_matches_plain(dev, r):
    """The float32 route's three TF32 products a step: rtol 1e-5, and no
    score off by more than 5e-6 of itself (one TF32 product alone gives
    about 2e-5: tests/test_torch_fused_tf32_split.py)."""
    params, x, q = _fused_f32_case(dev, r)
    got = fused_ray_scores(params, q, _valid(dev), x)
    torch.cuda.synchronize()
    want = fused_ray_scores_plain(params, q, _valid(dev), x)
    _assert_scores_close(got, want, rtol=1e-5)
    assert float(((got - want).abs() / want.abs()).max()) <= 5e-6


def test_fused_f32_kernel_is_deterministic(dev):
    """Tiles and partial statistics are folded in a fixed order."""
    params, x, q = _fused_f32_case(dev, 70001)
    first = fused_ray_scores(params, q, _valid(dev), x)
    assert torch.equal(first, fused_ray_scores(params, q, _valid(dev), x))


@pytest.mark.parametrize("r", [129, 70001])
def test_fused_f32_kernel_all_invalid_mask_gives_zeros(dev, r):
    params, x, q = _fused_f32_case(dev, r)
    none = torch.zeros(256, dtype=torch.bool, device=dev)
    assert not bool(fused_ray_scores(params, q, none, x).any())


def test_fused_f32_kernel_refuses_a_width_and_scoring_goes_exact(dev):
    """Layers 512 wide, which the float32 kernel does not take: the wrapper
    raises before any launch, and the fused-scoring route scores on the
    plain chain, as the JAX package falls back to XLA."""
    cfg = IDConfig(ray_feature_c=512, backbone=ViTConfig(depth=1))
    params = init_id_module(torch.Generator().manual_seed(2), cfg, device=dev)
    g = torch.Generator().manual_seed(2)
    x = torch.randn((1021, cfg.ray_in_dim), generator=g).to(dev)
    q = torch.randn((256, 384), generator=g).to(dev)
    rd = torch.randn((1021, 3), generator=g)
    rays = (torch.rand((1021, 3), generator=g).to(dev) * 2 - 1,
            (rd / rd.norm(dim=-1, keepdim=True)).to(dev),
            torch.rand((1021, 3), generator=g).to(dev))
    img = torch.rand((96, 96, 3), generator=g).to(dev)
    mask = torch.ones((96, 96), dtype=torch.bool, device=dev)
    before = fused_ray_scores.launches
    with pytest.raises(ValueError, match="unsupported widths"):
        fused_ray_scores(params, q, _valid(dev), x)
    got = _scores_maybe_fused(params, dataclasses.replace(cfg, fused_scoring=True),
                              img, mask, *rays)
    want = _scores_maybe_fused(params, cfg, img, mask, *rays)
    assert fused_ray_scores.launches == before
    assert torch.equal(got, want)


def _fused_bf16_case(dev, r, width=256):
    cfg = IDConfig(compute_dtype="bfloat16", ray_feature_c=width,
                   backbone=ViTConfig(depth=1))
    params = init_id_module(torch.Generator().manual_seed(width), cfg, device=dev)
    g = torch.Generator().manual_seed(r)
    x = torch.randn((r, cfg.ray_in_dim), generator=g).to(dev, torch.bfloat16)
    q = torch.randn((256, 384), generator=g).to(dev, torch.bfloat16)
    return cfg, params, x, q


def test_fused_bf16_kernel_is_deterministic(dev):
    """Tiles and partial statistics are folded in a fixed order, and no
    ring stage is freed before the products that read it complete."""
    _, params, x, q = _fused_bf16_case(dev, 70001)
    first = fused_ray_scores(params, q, _valid(dev), x)
    assert torch.equal(first, fused_ray_scores(params, q, _valid(dev), x))


@pytest.mark.parametrize("r", [1, 1021])
def test_fused_bf16_kernel_all_invalid_mask_gives_zeros(dev, r):
    _, params, x, q = _fused_bf16_case(dev, r)
    none = torch.zeros(256, dtype=torch.bool, device=dev)
    assert not bool(fused_ray_scores(params, q, none, x).any())


@pytest.mark.parametrize("width", [128, 512])
@pytest.mark.parametrize("r", [65, 70001])
def test_fused_bf16_kernel_matches_plain_at_widths(dev, width, r):
    """Ray layers 128 wide (wgmma N = 64 a warpgroup) and 512 wide (N =
    256, two ring stages), against the plain version at rtol 1e-3."""
    _, params, x, q = _fused_bf16_case(dev, r, width)
    got = fused_ray_scores(params, q, _valid(dev), x)
    torch.cuda.synchronize()
    want = fused_ray_scores_plain(params, q, _valid(dev), x)
    _assert_scores_close(got, want, rtol=1e-3)


def test_fused_bf16_kernel_refuses_a_width_and_scoring_goes_exact(dev):
    """Layers 192 wide, which the bf16 route does not take: the wrapper
    raises before any launch, and the fused-scoring route scores on the
    plain chain, as the JAX package falls back to XLA."""
    cfg, params, x, q = _fused_bf16_case(dev, 1021, 192)
    g = torch.Generator().manual_seed(5)
    rd = torch.randn((1021, 3), generator=g)
    rays = (torch.rand((1021, 3), generator=g).to(dev) * 2 - 1,
            (rd / rd.norm(dim=-1, keepdim=True)).to(dev),
            torch.rand((1021, 3), generator=g).to(dev))
    img = torch.rand((96, 96, 3), generator=g).to(dev)
    mask = torch.ones((96, 96), dtype=torch.bool, device=dev)
    before = fused_ray_scores.launches
    with pytest.raises(ValueError, match="unsupported widths"):
        fused_ray_scores(params, q, _valid(dev), x)
    got = _scores_maybe_fused(params, dataclasses.replace(cfg, fused_scoring=True),
                              img, mask, *rays)
    want = _scores_maybe_fused(params, cfg, img, mask, *rays)
    assert fused_ray_scores.launches == before
    assert torch.equal(got, want)


def test_fused_bf16_kernel_refuses_an_unaligned_x(dev):
    """Rows of 141 bf16 from an odd row on start at a 2-byte boundary: the
    kernel copies a tile's rows 16 bytes at a time, so the wrapper raises
    before any launch."""
    _, params, x, q = _fused_bf16_case(dev, 1021)
    before = fused_ray_scores.launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        fused_ray_scores(params, q, _valid(dev), x[1:])
    assert fused_ray_scores.launches == before


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("r,c", [(90000, 256), (90000, 48), (90000, 16),
                                 (300, 48), (300 ** 3, 1), (1000, 3)])
@pytest.mark.parametrize("n", [0, 1, 1021, 204660])
def test_gather_kernel_matches_plain(dev, r, c, n, aligned):
    """Exact: rows are copied, never computed. The first indices are the
    edges R - 1, R and -R - 1 (NaN rows), -1 and -R (wrapped). [90000, 256]
    with 204 660 indices takes the bucketed route, every other case the
    direct one."""
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


def test_gather_kernel_matches_plain_at_stacked_mask_corners(dev):
    """One mask lookup's index array: the 8 stacked trilinear corners of
    204 660 points in and just beyond a [300^3, 1] volume, exactly."""
    g = torch.Generator().manual_seed(3)
    table = torch.randn((300 ** 3, 1), generator=g).to(dev)
    coords = (torch.rand((204660, 3), generator=g) * 2.1 - 1.05).to(dev)
    idx = corners_3d(300, 300, 300, coords)[0].reshape(-1)
    got = gather_rows(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, gather_rows_plain(table, idx))


def test_each_grid_sampler_launches_the_gather_once(dev):
    g = torch.Generator().manual_seed(4)
    coords = (torch.rand((999, 3), generator=g) * 2.2 - 1.1).to(dev)
    cases = ((grid_sample_1d, torch.randn((30, 16), generator=g), coords[:, 0]),
             (grid_sample_2d, torch.randn((20, 30, 48), generator=g), coords[:, :2]),
             (grid_sample_3d, torch.randn((10, 20, 30), generator=g), coords))
    for fn, grid, xyz in cases:
        before = gather_rows.launches
        fn(grid.to(dev), xyz)
        assert gather_rows.launches == before + 1, fn.__name__


# flower's uneven ranks (configs/flower.txt) on a grid of its AABB's
# proportions: per-pair widths of 16, 4 and 4 float4 words; Repair's
# (configs/repair_27_RPf_00192b.txt) at its final 377x377x188 grid: 16, 16
# and 4
FIELDS = {"lego": ((300, 300, 300), (16, 16, 16), (48, 48, 48)),
          "non_cubic": ((160, 170, 180), (16, 12, 8), (48, 40, 24)),
          "flower": ((160, 178, 107), (16, 4, 4), (48, 12, 12)),
          "repair": ((377, 377, 188), (16, 16, 4), (48, 48, 12)),
          "non_cubic_scalar": ((16, 17, 18), (2, 3, 4), (3, 4, 5))}


def _field(shape, dev):
    grid, rd, ra = shape
    g = torch.Generator().manual_seed(5)
    params = {}
    for kind, ranks in (("density", rd), ("app", ra)):
        params[f"{kind}_plane"] = tuple(
            (0.5 + 0.1 * torch.randn((grid[m1], grid[m0], ranks[i]),
                                     generator=g)).to(dev)
            for i, (m0, m1) in enumerate(MAT_MODE))
        params[f"{kind}_line"] = tuple(
            (0.5 + 0.1 * torch.randn((grid[VEC_MODE[i]], ranks[i]),
                                     generator=g)).to(dev)
            for i in range(3))
    return FieldConfig(grid_size=grid, density_n_comp=rd, app_n_comp=ra), params


@pytest.fixture(scope="module", params=sorted(FIELDS))
def vm_field(request, dev):
    return _field(FIELDS[request.param], dev)


@pytest.mark.parametrize("with_app", [False, True])
@pytest.mark.parametrize("n", [0, 1, 1021, 204660])
def test_field_kernel_matches_plain(dev, vm_field, n, with_app, monkeypatch):
    """Float32 in another order (sigma's sum over ranks): rtol 1e-5 and an
    atol of 1e-6 x max|plain|, against the grid samplers on plain
    gathers, at points in and beyond [-1, 1] and on the grid's corners."""
    config, params = vm_field
    g = torch.Generator().manual_seed(n)
    xyz = torch.rand((n, 3), generator=g) * 2.4 - 1.2
    xyz[:2] = torch.tensor([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]])[:n]
    xyz = xyz.to(dev)
    got = field_features(config, params, xyz, with_app)
    torch.cuda.synchronize()
    monkeypatch.setattr(grid_sample_module, "gather_rows", gather_rows_plain)
    want = field_features_plain(params, xyz, with_app)
    assert (got[1] is None) == (not with_app)
    for a, b in zip(got, want):
        if b is None:
            continue
        assert a.shape == b.shape
        scale = float(b.abs().max()) if n else 0.0
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * scale)


# the backward kernel against autograd's gradient through the samplers:
# float32 sums of up to thousands of terms a texel (2e5 samples on grids of
# 16-300 texels a side), added by atomics in another order than autograd's
# index_add; the worst case grows as n x 6e-8 of the terms' magnitudes
FIELD_GRAD_TOL = 1e-4


def _backward_inputs(config, layout, n, dev):
    """(xyz, dsigma, dapp) on the card for a backward case: ``scattered``
    points in and beyond [-1, 1] and on the grid's corners, upstream
    gradients of both signs with a tenth of them zero; or ``n`` samples of
    rays in the order training samples them, half a texel apart, each
    about two grid widths long (so crossing the grid and leaving it):
    along the axes, the diagonals or both (``rays``), the upstream with
    stretches of zeros inside runs (``ray_upstream``). ``n`` may also be
    "run-1", "run", "run+1" or "2run+1": the kernel's run length read from
    its source, and those next to it."""
    width = sum(config.app_n_comp)
    if layout == "scattered":
        g = torch.Generator().manual_seed(100 + n)
        xyz = torch.rand((n, 3), generator=g) * 2.4 - 1.2
        xyz[:2] = torch.tensor([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]])[:n]
        dsigma = torch.randn(n, generator=g)
        dsigma[::10] = 0.0
        dapp = torch.randn((n, width), generator=g)
        dapp[::7] = 0.0
        return xyz.to(dev), dsigma.to(dev), dapp.to(dev)
    xyz = _ray_xyz(config, layout, n, "kRunSamples")
    dsigma, dapp = ray_upstream(xyz.shape[0], width, 8)
    return tuple(torch.as_tensor(a, device=dev) for a in (xyz, dsigma, dapp))


def _ray_xyz(config, layout, n, run_name):
    """``n`` ray-ordered samples (numpy) as ``_backward_inputs`` lays them
    out; ``n`` may be "run-1", "run", "run+1" or "2run+1" of the run
    length ``run_name`` read from the kernel's source."""
    if isinstance(n, str):
        run = run_samples(Path(__file__).resolve().parents[1], run_name)
        n = {"run-1": run - 1, "run": run, "run+1": run + 1,
             "2run+1": 2 * run + 1}[n]
    dirs = {"axes": AXES, "diagonals": DIAGONALS, "rays": AXES + DIAGONALS}[layout]
    per_ray = 2 * max(config.grid_size) + 37
    return np.concatenate([
        ray_ordered_samples(config.grid_size, dirs, per_ray, 7 + k, spread=0.9)
        for k in range(-(-n // (per_ray * len(dirs))))])[:n]


# scattered points, then ray-ordered samples: rays along each axis (hot
# rows) and the diagonals, at half-texel steps, crossing ray ends inside
# runs, zero-upstream stretches inside runs, samples beyond [-1, 1], and
# sample counts at the run length's edges
BACKWARD_CASES = ([("scattered", n) for n in (0, 1, 1021, 204660)]
                  + [("axes", 120000), ("diagonals", 60000), ("rays", 1),
                     ("rays", "run-1"), ("rays", "run"), ("rays", "run+1"),
                     ("rays", "2run+1"), ("rays", 50001)])


@pytest.mark.parametrize("with_app", [False, True])
@pytest.mark.parametrize("layout,n", BACKWARD_CASES)
def test_field_backward_kernel_matches_plain(dev, vm_field, layout, n, with_app):
    """The backward kernel's 6 or 12 table gradients against
    field_features_backward_plain, each within FIELD_GRAD_TOL of its
    largest, on scattered points and on ray-ordered samples
    (``_backward_inputs``): flagged-out corners add nothing, zero upstream
    words are skipped, runs merge sums across ray ends. Lego's 300^3 grid
    (float4 words), two non-cubic grids (one at flower's ranks 16/4/4
    and 48/12/12) and one with ranks 2-5 (4-byte words), density-only and with appearance."""
    config, params = vm_field
    xyz, dsigma, dapp = _backward_inputs(config, layout, n, dev)
    n = xyz.shape[0]
    before = field_features_backward.launches
    got = field_features_backward(config, params, xyz, dsigma,
                                  dapp if with_app else None)
    torch.cuda.synchronize()
    assert field_features_backward.launches == before + (n > 0)
    want = field_features_backward_plain(params, xyz, dsigma,
                                         dapp if with_app else None)
    assert sorted(got) == sorted(TABLES if with_app else TABLES[:2])
    for name in want:
        for i, (a, b) in enumerate(zip(got[name], want[name])):
            assert a.shape == b.shape
            scale = float(b.abs().max()) if n else 0.0
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=FIELD_GRAD_TOL * scale,
                                       msg=f"{name}[{i}]")


@pytest.mark.parametrize("unaligned", ["table", "upstream"])
def test_field_backward_kernel_matches_plain_unaligned(dev, unaligned):
    """Lego's ranks on a small grid, ray-ordered samples, with one table 4
    bytes off 16-byte alignment (the scalar route, whose 64 words a pair
    take two passes of a block over each span) or with dsigma so (the
    float4 route reading every stage from global memory, no ring): within
    FIELD_GRAD_TOL of field_features_backward_plain."""
    config, params = _field(((40, 44, 48), (16, 16, 16), (48, 48, 48)), dev)
    xyz, dsigma, dapp = _backward_inputs(config, "rays", 30001, dev)

    def shifted(a):
        out = torch.empty(a.numel() + 1, device=dev)[1:].view(a.shape)
        out.copy_(a)
        return out
    if unaligned == "table":
        params = dict(params, app_plane=(shifted(params["app_plane"][0]),)
                      + params["app_plane"][1:])
    else:
        dsigma = shifted(dsigma)
    before = field_features_backward.launches
    got = field_features_backward(config, params, xyz, dsigma, dapp)
    torch.cuda.synchronize()
    assert field_features_backward.launches == before + 1
    want = field_features_backward_plain(params, xyz, dsigma, dapp)
    for name in want:
        for i, (a, b) in enumerate(zip(got[name], want[name])):
            torch.testing.assert_close(
                a, b, rtol=0, atol=FIELD_GRAD_TOL * float(b.abs().max()),
                msg=f"{name}[{i}]")


# the forward on ray-ordered samples: the ray layouts of BACKWARD_CASES
# (their run-length edges read as the forward's longest run, kMaxRun, which
# small calls shorten) and a count at which the host's rule gives every
# mode and word size the longest run, its last span part-filled
FORWARD_CASES = ([case for case in BACKWARD_CASES if case[0] != "scattered"]
                 + [("rays", 2_200_001)])


def _forward_xyz(config, layout, n, dev):
    return torch.as_tensor(_ray_xyz(config, layout, n, "kMaxRun"), device=dev)


def _assert_forward_matches_plain(config, params, xyz, with_app):
    """One launch; app products bit-equal to the plain version's on plain
    gathers, sigma within rtol 1e-5 and an atol of 1e-6 x max|plain|."""
    before = field_features.launches
    got = field_features(config, params, xyz, with_app)
    torch.cuda.synchronize()
    assert field_features.launches == before + (xyz.shape[0] > 0)
    want = field_features_plain(params, xyz, with_app, gather_rows_plain)
    assert (got[1] is None) == (not with_app)
    scale = float(want[0].abs().max()) if xyz.shape[0] else 0.0
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6 * scale)
    if with_app:
        assert got[1].shape == want[1].shape
        assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("with_app", [False, True])
@pytest.mark.parametrize("layout,n", FORWARD_CASES)
def test_field_forward_kernel_matches_plain_on_rays(dev, vm_field, layout, n,
                                                    with_app):
    """The forward kernel's walk on ray-ordered samples (rays along the
    axes and the diagonals at half-texel steps, leaving [-1, 1], ray ends
    inside runs; sample counts at the edges of the longest run and one
    that takes it): app products bit-equal to the plain version's, sigma
    within its tolerance. Lego's 300^3 grid (float4 words), two non-cubic
    grids (one at flower's ranks 16/4/4 and 48/12/12) and one with ranks
    2-5 (4-byte words), density-only and with
    appearance."""
    config, params = vm_field
    _assert_forward_matches_plain(config, params,
                                  _forward_xyz(config, layout, n, dev), with_app)


@pytest.mark.parametrize("unaligned", ["table", "xyz"])
def test_field_forward_kernel_matches_plain_unaligned(dev, unaligned):
    """Lego's ranks on a small grid, ray-ordered samples long enough for
    the longest run, with one table 4 bytes off 16-byte alignment (the
    4-byte route: 2 groups a pair) or with xyz so (the float4 route, its
    coordinates staged by 4-byte loads): bit-equal app products."""
    config, params = _field(((40, 44, 48), (16, 16, 16), (48, 48, 48)), dev)
    xyz = _forward_xyz(config, "rays", 2_200_001, dev)

    def shifted(a):
        out = torch.empty(a.numel() + 1, device=dev)[1:].view(a.shape)
        out.copy_(a)
        return out
    if unaligned == "table":
        params = dict(params, app_line=params["app_line"][:2]
                      + (shifted(params["app_line"][2]),))
    else:
        xyz = shifted(xyz)
    _assert_forward_matches_plain(config, params, xyz, True)


def test_field_features_autograd_runs_the_backward_kernel(dev):
    """A loss through field_features and basis_mat under autograd: the
    tables' gradients come from the backward kernel (one launch) and equal
    the plain route's within FIELD_GRAD_TOL; the coordinate kernel does
    not launch while xyz does not require grad, and when xyz requires grad
    too, both backward kernels launch once and xyz's gradient equals the
    plain route's within COORDS_GRAD_TOL."""
    config, field = _field(FIELDS["non_cubic"], dev)
    g = torch.Generator().manual_seed(3)
    xyz = (torch.rand((50000, 3), generator=g) * 2 - 1).to(dev)
    w = torch.randn((sum(config.app_n_comp), 27), generator=g).to(dev)
    for xyz_grad in (False, True):
        leaves = {k: tuple(a.clone().requires_grad_() for a in field[k])
                  for k in TABLES}
        leaf = xyz.clone().requires_grad_(xyz_grad)
        before = (field_features_backward.launches,
                  field_features_coords_grad.launches)
        sigma, app = field_features(config, leaves, leaf, True)
        (sigma.square().sum() + (app @ w).sin().sum()).backward()
        torch.cuda.synchronize()
        assert (field_features_backward.launches,
                field_features_coords_grad.launches) == (
                    before[0] + 1, before[1] + xyz_grad)
        plain = {k: tuple(a.detach().clone().requires_grad_()
                          for a in field[k]) for k in TABLES}
        plain_xyz = xyz.clone().requires_grad_(xyz_grad)
        s2, a2 = field_features_plain(plain, plain_xyz, True,
                                      gather_rows_plain)
        (s2.square().sum() + (a2 @ w).sin().sum()).backward()
        for name in TABLES:
            for a, b in zip(leaves[name], plain[name]):
                torch.testing.assert_close(
                    a.grad, b.grad, rtol=0,
                    atol=FIELD_GRAD_TOL * float(b.grad.abs().max()))
        if xyz_grad:
            torch.testing.assert_close(
                leaf.grad, plain_xyz.grad, rtol=0,
                atol=COORDS_GRAD_TOL * float(plain_xyz.grad.abs().max()))


# the coordinate kernel against autograd's coordinate gradient through the
# samplers: each coordinate sums up to 3 x (Rd + Ra) rank terms (192 at
# lego's ranks) of lerped corner differences in another order (shuffles
# against autograd's), n x 6e-8 of the terms' magnitudes at worst
COORDS_GRAD_TOL = 1e-4


def _coords_inputs(config, n, dev):
    """``_backward_inputs``' scattered points and upstream, a quarter of
    the points moved onto texels (every coordinate on a texel of its
    axis)."""
    xyz, dsigma, dapp = _backward_inputs(config, "scattered", n, dev)
    sizes = torch.tensor(config.grid_size, dtype=torch.float32)
    g = torch.Generator().manual_seed(300 + n)
    texel = torch.floor(torch.rand((n // 4, 3), generator=g) * sizes)
    xyz[2:2 + n // 4] = (texel * 2 / (sizes - 1) - 1).to(dev)[:max(n - 2, 0)]
    return xyz, dsigma, dapp


def _assert_coords_grad_matches_plain(config, params, xyz, dsigma, dapp):
    before = field_features_coords_grad.launches
    got = field_features_coords_grad(config, params, xyz, dsigma, dapp)
    torch.cuda.synchronize()
    assert field_features_coords_grad.launches == before + (xyz.shape[0] > 0)
    want = field_features_coords_grad_plain(params, xyz, dsigma, dapp)
    assert got.shape == want.shape == xyz.shape
    scale = float(want.abs().max()) if xyz.shape[0] else 0.0
    torch.testing.assert_close(got, want, rtol=0, atol=COORDS_GRAD_TOL * scale)
    zero = (dsigma == 0) if dapp is None else (dsigma == 0) & ~dapp.any(-1)
    assert not got[zero].any()  # no upstream, no gradient


@pytest.mark.parametrize("with_app", [False, True])
@pytest.mark.parametrize("n", [0, 1, 1021, 204660])
def test_field_coords_grad_kernel_matches_plain(dev, vm_field, n, with_app):
    """The coordinate kernel against field_features_coords_grad_plain
    within COORDS_GRAD_TOL of the largest |dxyz|, at points in and beyond
    [-1, 1] and on texel boundaries (the forward's cells), samples without
    upstream giving zeros. Lego's 300^3 grid (float4 words), two non-cubic
    grids (one at flower's ranks 16/4/4 and 48/12/12) and one with ranks
    2-5 (4-byte words), density-only and with
    appearance."""
    config, params = vm_field
    xyz, dsigma, dapp = _coords_inputs(config, n, dev)
    _assert_coords_grad_matches_plain(config, params, xyz, dsigma,
                                      dapp if with_app else None)


@pytest.mark.parametrize("layout", ["axes", "rays"])
def test_field_coords_grad_kernel_matches_plain_on_rays(dev, vm_field, layout):
    """Ray-ordered samples (rays along the axes, and along the axes and
    the diagonals, at half-texel steps, leaving [-1, 1]) with stretches of
    zero upstream: within COORDS_GRAD_TOL of the plain version."""
    config, params = vm_field
    xyz, dsigma, dapp = _backward_inputs(config, layout, 60000, dev)
    _assert_coords_grad_matches_plain(config, params, xyz, dsigma, dapp)


@pytest.mark.parametrize("unaligned", ["table", "upstream"])
def test_field_coords_grad_kernel_matches_plain_unaligned(dev, unaligned):
    """Lego's ranks on a small grid with one table, or dapp, 4 bytes off
    16-byte alignment: the 4-byte route, within COORDS_GRAD_TOL."""
    config, params = _field(((40, 44, 48), (16, 16, 16), (48, 48, 48)), dev)
    xyz, dsigma, dapp = _coords_inputs(config, 30001, dev)

    def shifted(a):
        out = torch.empty(a.numel() + 1, device=dev)[1:].view(a.shape)
        out.copy_(a)
        return out
    if unaligned == "table":
        lines = params["density_line"]
        params = dict(params, density_line=(shifted(lines[0]),) + lines[1:])
    else:
        dapp = shifted(dapp)
    _assert_coords_grad_matches_plain(config, params, xyz, dsigma, dapp)


def test_field_coords_grad_kernel_zero_upstream_gives_zero(dev):
    """All upstream zero: a zero gradient for every sample, one launch."""
    config, params = _field(FIELDS["lego"], dev)
    xyz, dsigma, dapp = _coords_inputs(config, 1021, dev)
    got = field_features_coords_grad(config, params, xyz,
                                     torch.zeros_like(dsigma),
                                     torch.zeros_like(dapp))
    assert not got.any()


def test_field_coords_grad_kernel_refuses_mismatched_upstream(dev):
    """An upstream of another shape or device is refused before a launch."""
    config, params = _field(FIELDS["non_cubic"], dev)
    xyz, dsigma, dapp = _coords_inputs(config, 1021, dev)
    before = field_features_coords_grad.launches
    for bad in ((dsigma[:-1], dapp), (dsigma, dapp[:, :-1]),
                (dsigma.cpu(), dapp)):
        with pytest.raises(ValueError, match="upstream"):
            field_features_coords_grad(config, params, xyz, *bad)
    assert field_features_coords_grad.launches == before


# the coordinate kernel's walk: ray-ordered samples half a texel or a texel
# apart (rays along the axes and the diagonals, leaving [-1, 1]), at sample
# counts around its run (kCoordRun, from its source) and lego's stage of 5
# runs, and odd counts
COORD_CASES = ([(0.5, n) for n in (1, "run-1", "run", "run+1", "2run+1", 39,
                                   40, 41, 81, 100001)]
               + [(1.0, n) for n in (41, 60000, 100001)])


def _coords_ray_inputs(config, texels, n, dev):
    """``n`` ray-ordered samples ``texels`` texels apart and their
    upstream: normal, with dead samples inside runs (3 of every 12), whole
    dead runs (every third stretch of 97), dsigma alone zero on every fifth
    sample and dapp alone zero on every seventh."""
    if isinstance(n, str):
        run = run_samples(Path(__file__).resolve().parents[1], "kCoordRun")
        n = {"run-1": run - 1, "run": run, "run+1": run + 1,
             "2run+1": 2 * run + 1}[n]
    per_ray = int((2 * max(config.grid_size) + 37) / (2 * texels))
    dirs = AXES + DIAGONALS
    xyz = np.concatenate([
        ray_ordered_samples(config.grid_size, dirs, per_ray, 11 + k,
                            spread=0.9, texels=texels)
        for k in range(-(-n // (per_ray * len(dirs))))])[:n]
    rng = np.random.default_rng(n)
    width = sum(config.app_n_comp)
    dsigma = rng.standard_normal(n).astype(np.float32)
    dapp = rng.standard_normal((n, width)).astype(np.float32)
    k = np.arange(n)
    dead = ((k // 3) % 4 == 1) | ((k // 97) % 3 == 2)
    dsigma[dead | (k % 5 == 0)] = 0.0
    dapp[dead | (k % 7 == 0)] = 0.0
    return tuple(torch.as_tensor(a, device=dev) for a in (xyz, dsigma, dapp))


@pytest.mark.parametrize("with_app", [False, True])
@pytest.mark.parametrize("texels,n", COORD_CASES)
def test_field_coords_grad_kernel_walks_rays(dev, vm_field, texels, n,
                                             with_app):
    """The coordinate kernel's walk of each run's live samples against
    field_features_coords_grad_plain within COORDS_GRAD_TOL, samples
    without upstream exactly 0, and a second call bit-equal to the first:
    every field's ranks (float4 and 4-byte words), density-only and with
    appearance."""
    config, params = vm_field
    xyz, dsigma, dapp = _coords_ray_inputs(config, texels, n, dev)
    dapp = dapp if with_app else None
    _assert_coords_grad_matches_plain(config, params, xyz, dsigma, dapp)
    first = field_features_coords_grad(config, params, xyz, dsigma, dapp)
    again = field_features_coords_grad(config, params, xyz, dsigma, dapp)
    assert torch.equal(first, again)


def test_field_coords_grad_kernel_all_live_repeats_bit_equal(dev):
    """Lego's ranks on an all-live ray-ordered set (every upstream word
    normal): within COORDS_GRAD_TOL of the plain version, and bit-equal
    across repeats (no atomics: the parts meet in a fixed order)."""
    config, params = _field(FIELDS["lego"], dev)
    xyz, _, _ = _coords_ray_inputs(config, 0.5, 200001, dev)
    g = torch.Generator().manual_seed(17)
    dsigma = torch.randn(xyz.shape[0], generator=g).to(dev)
    dapp = torch.randn((xyz.shape[0], sum(config.app_n_comp)),
                       generator=g).to(dev)
    _assert_coords_grad_matches_plain(config, params, xyz, dsigma, dapp)
    first = field_features_coords_grad(config, params, xyz, dsigma, dapp)
    for _ in range(3):
        assert torch.equal(field_features_coords_grad(config, params, xyz,
                                                      dsigma, dapp), first)


def test_field_features_autograd_both_gradients_on_rays(dev):
    """Under autograd with the tables and xyz requiring grad, on
    ray-ordered samples at flower's ranks with dead samples in the
    upstream (a loss masked as the renderer masks it): one launch of each
    backward kernel, the tables' gradients within FIELD_GRAD_TOL and xyz's
    within COORDS_GRAD_TOL of the plain route's."""
    config, field = _field(FIELDS["flower"], dev)
    xyz, dsigma, dapp = _coords_ray_inputs(config, 0.5, 50001, dev)
    keep_sigma, keep_app = (dsigma != 0).float(), (dapp != 0).float()
    g = torch.Generator().manual_seed(4)
    w = torch.randn((sum(config.app_n_comp), 27), generator=g).to(dev)

    def loss(sigma, app):
        return ((sigma * keep_sigma).square().sum()
                + ((app * keep_app) @ w).sin().sum())

    leaves = {k: tuple(a.clone().requires_grad_() for a in field[k])
              for k in TABLES}
    leaf = xyz.clone().requires_grad_()
    before = (field_features_backward.launches,
              field_features_coords_grad.launches)
    loss(*field_features(config, leaves, leaf, True)).backward()
    torch.cuda.synchronize()
    assert (field_features_backward.launches,
            field_features_coords_grad.launches) == (before[0] + 1,
                                                     before[1] + 1)
    plain = {k: tuple(a.detach().clone().requires_grad_() for a in field[k])
             for k in TABLES}
    plain_xyz = xyz.clone().requires_grad_()
    loss(*field_features_plain(plain, plain_xyz, True,
                               gather_rows_plain)).backward()
    for name in TABLES:
        for a, b in zip(leaves[name], plain[name]):
            torch.testing.assert_close(
                a.grad, b.grad, rtol=0,
                atol=FIELD_GRAD_TOL * float(b.grad.abs().max()))
    torch.testing.assert_close(
        leaf.grad, plain_xyz.grad, rtol=0,
        atol=COORDS_GRAD_TOL * float(plain_xyz.grad.abs().max()))
    dead = (dsigma == 0) & (dapp == 0).all(-1)
    assert not leaf.grad[dead].any()


def _unisphere_samples(config, n, dev):
    """``n`` samples of ``sample_ray`` under the unisphere contraction
    (training jitter, the background steps) on rays from a sphere of
    radius 5 towards the centre of a box of half-extent 3, mapped by
    ``normalize_coord``'s power contraction: the outer samples lie beyond
    [-1, 1] (up to 5/3), in ray order."""
    from iffnerf_tpu_torch.models.field import normalize_coord
    from iffnerf_tpu_torch.models.render import sample_ray

    cfg = config.replace(aabb=((-3.0,) * 3, (3.0,) * 3),
                         contraction_type="unisphere", step_ratio=0.5,
                         near_far=(0.5, 12.0))
    g = torch.Generator().manual_seed(21)
    per_ray = cfg.n_samples + cfg.n_samples_bg
    rays = -(-n // per_ray)
    o = torch.randn((rays, 3), generator=g)
    o = 5.0 * o / o.norm(dim=-1, keepdim=True)
    d = torch.rand((rays, 3), generator=g) * 1.6 - 0.8 - o
    d = d / d.norm(dim=-1, keepdim=True)
    xyz, _, _ = sample_ray(cfg, o, d, jitter=torch.rand((rays, 1),
                                                        generator=g))
    coords = normalize_coord(cfg, xyz).reshape(-1, 3)[:n]
    return coords.contiguous().to(dev)


@pytest.mark.parametrize("n", [1021, 204660])
def test_field_kernels_match_plain_at_unisphere_samples(dev, vm_field, n):
    """The forward (app products bit-equal), the backward and the
    coordinate gradient at unisphere samples, some beyond [-1, 1] where
    the plain version (the grid samplers' zero padding) reads nothing,
    against their plain versions within their tolerances."""
    config, params = vm_field
    xyz = _unisphere_samples(config, n, dev)
    assert float((xyz.abs() > 1).any(-1).float().mean()) > 0.05
    assert float(xyz.abs().max()) < 5 / 3
    _assert_forward_matches_plain(config, params, xyz, True)
    g = torch.Generator().manual_seed(n)
    dsigma = torch.randn(n, generator=g).to(dev)
    dapp = torch.randn((n, sum(config.app_n_comp)), generator=g).to(dev)
    got = field_features_backward(config, params, xyz, dsigma, dapp)
    want = field_features_backward_plain(params, xyz, dsigma, dapp)
    for name in want:
        for i, (a, b) in enumerate(zip(got[name], want[name])):
            torch.testing.assert_close(
                a, b, rtol=0, atol=FIELD_GRAD_TOL * float(b.abs().max()),
                msg=f"{name}[{i}]")
    _assert_coords_grad_matches_plain(config, params, xyz, dsigma, dapp)


@pytest.mark.parametrize("chunk", ["first", "last"])
def test_field_forward_density_only_on_a_dense_lattice(dev, vm_field, chunk):
    """The density-only forward on a chunk of the dense alpha's lattice
    (``get_dense_alpha``: every texel of the field's grid, x slowest, in
    chunks of DENSE_ALPHA_CHUNK points; the first chunk, or the ragged
    last one), every point on a texel: within its tolerance of the plain
    version."""
    from iffnerf_tpu_torch.models.field import (
        DENSE_ALPHA_CHUNK,
        _lattice_axis,
        normalize_coord,
    )

    config, params = vm_field
    axes = [torch.as_tensor(_lattice_axis(gs), device=dev)
            for gs in config.grid_size]
    aabb = torch.as_tensor(config.aabb_np, device=dev)
    lattice = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)
    flat = (aabb[0] * (1 - lattice) + aabb[1] * lattice).reshape(-1, 3)
    n = flat.shape[0]
    start = 0 if chunk == "first" else (n - 1) // DENSE_ALPHA_CHUNK * \
        DENSE_ALPHA_CHUNK
    xyz = normalize_coord(config, flat[start:start + DENSE_ALPHA_CHUNK])
    del lattice, flat
    _assert_forward_matches_plain(config, params, xyz.contiguous(), False)


# ---------------------------------------------------------------------------
# TensorCP kernels and K3's backward
# ---------------------------------------------------------------------------

# the CP line gradient of each line's largest |grad|: float32 sums of up to
# N / L terms a texel, merged in registers and shared memory and added by
# atomics in another order than autograd's index_add (chip_smoke.py)
CP_GRAD_TOL = 1e-4
CP_FIELDS = {"r1": ((23, 19, 17), 1, 1), "r5": ((64, 60, 57), 5, 5),
             "r47": ((130, 140, 150), 47, 5), "lego": ((500, 480, 520), 96, 288)}
CP_CFG = FieldConfig(model_name="TensorCP")


def _cp_lines(name, dev, seed=0):
    (a, b, c), rd, ra = CP_FIELDS[name]
    g = torch.Generator().manual_seed(seed)
    return {k: tuple((0.5 * torch.randn((length, r), generator=g)).to(dev)
                     for length in (c, b, a))
            for k, r in (("density_line", rd), ("app_line", ra))}


def _cp_samples(n, dev, seed=0, spread=1.2):
    """Ray-ordered samples half a hundredth apart (consecutive samples in
    one cell, as a step's), starting within ``spread`` of the centre."""
    g = torch.Generator().manual_seed(seed)
    per = 100
    o = (torch.rand((max(-(-n // per), 1), 1, 3), generator=g) * 2 - 1) * spread
    d = torch.nn.functional.normalize(torch.randn(o.shape, generator=g), dim=-1)
    t = torch.arange(per, dtype=torch.float32)[None, :, None] * 0.005
    return (o + d * t).reshape(-1, 3)[:n].contiguous().to(dev)


def _cp_upstream(params, n, dev, seed=1):
    g = torch.Generator().manual_seed(seed)
    live = torch.rand(n, generator=g) > 0.3
    dsigma = torch.randn(n, generator=g) * live
    dapp = torch.randn((n, params["app_line"][0].shape[1]), generator=g) * live[:, None]
    return dsigma.to(dev), dapp.to(dev)


def _cp_chunked(fn, xyz, *ups, chunk=1 << 20, total=False):
    outs = [fn(xyz[i:i + chunk], *(u[i:i + chunk] for u in ups))
            for i in range(0, max(xyz.shape[0], 1), chunk)]
    if total:
        return {k: tuple(sum(o[k][j] for o in outs) for j in range(3))
                for k in outs[0]}
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(p) for p in zip(*outs))
    return torch.cat(outs)


def _assert_cp_kernels_match_plain(params, xyz, dsigma, dapp):
    sigma, app = cpf.cp_features(CP_CFG, params, xyz)
    torch.cuda.synchronize()
    want_s, want_a = _cp_chunked(lambda x: cpf.cp_features_plain(
        params, x, True, gather_rows_plain), xyz)
    assert torch.equal(app, want_a)
    torch.testing.assert_close(sigma, want_s, rtol=1e-5, atol=1e-6 * float(
        want_s.abs().max()) if want_s.numel() else 0.0)
    only, none = cpf.cp_features(CP_CFG, params, xyz, with_app=False)
    assert none is None
    torch.testing.assert_close(only, want_s, rtol=1e-5, atol=1e-6 * float(
        want_s.abs().max()) if want_s.numel() else 0.0)
    got = cpf.cp_features_backward(CP_CFG, params, xyz, dsigma, dapp)
    want = _cp_chunked(lambda *a: cpf.cp_features_backward_plain(params, *a),
                       xyz, dsigma, dapp, total=True)
    for k in want:
        for a, b in zip(got[k], want[k]):
            torch.testing.assert_close(a, b, rtol=0, atol=CP_GRAD_TOL * max(
                float(b.abs().max()), 1e-30))
    got = cpf.cp_features_coords_grad(CP_CFG, params, xyz, dsigma, dapp)
    want = _cp_chunked(lambda *a: cpf.cp_features_coords_grad_plain(
        params, *a), xyz, dsigma, dapp)
    torch.testing.assert_close(got, want, rtol=0, atol=COORDS_GRAD_TOL * max(
        float(want.abs().max()) if want.numel() else 0.0, 1e-30))
    got = cpf.cp_features_coords_grad(CP_CFG, params, xyz, dsigma)
    want = _cp_chunked(lambda *a: cpf.cp_features_coords_grad_plain(
        params, *a), xyz, dsigma)
    torch.testing.assert_close(got, want, rtol=0, atol=COORDS_GRAD_TOL * max(
        float(want.abs().max()) if want.numel() else 0.0, 1e-30))


@pytest.mark.parametrize("name", sorted(CP_FIELDS))
@pytest.mark.parametrize("n", [0, 1, 63, 1021])
@pytest.mark.parametrize("spread", [0.9, 1.3])
def test_cp_kernels_match_plain(dev, name, n, spread):
    params = _cp_lines(name, dev)
    xyz = _cp_samples(n, dev, spread=spread)
    _assert_cp_kernels_match_plain(params, xyz, *_cp_upstream(params, n, dev))


def test_cp_kernels_match_plain_at_a_lego_cp_step(dev):
    """TensoRF's CP ranks 96 / 288 on uneven lines at a 4 096-ray step's
    7.1 M samples (1 731 a ray), the plain version in chunks."""
    params = _cp_lines("lego", dev, seed=3)
    n = 4096 * 1731
    xyz = _cp_samples(n, dev, seed=3)
    _assert_cp_kernels_match_plain(params, xyz, *_cp_upstream(params, n, dev))


def test_cp_kernels_scalar_words_and_unaligned_coords(dev):
    """Ranks not a multiple of 4 take 4-byte words; coordinates off the
    16-byte grid take them too. The coordinate kernel also at lego's ranks
    with the coordinates, then the appearance upstream, off the grid:
    4-byte words read from device memory, 384 words in four passes."""
    params = _cp_lines("r47", dev)
    buf = _cp_samples(1022 * 3, dev).reshape(-1)[:3067]
    xyz = buf[1:].view(1022, 3)
    _assert_cp_kernels_match_plain(params, xyz, *_cp_upstream(params, 1022, dev))
    params = _cp_lines("lego", dev, seed=20)
    n = 20 * 1728 + 5
    buf = _cp_samples(n + 1, dev, seed=20).reshape(-1)
    xyz = buf[1:1 + 3 * n].view(n, 3)
    dsigma, dapp = iteration_upstream(params, n, 20, dev)
    _assert_cp_coords_grad_matches_plain(params, xyz, dsigma, dapp)
    flat = torch.empty(dapp.numel() + 1, device=dev)
    flat[1:] = dapp.reshape(-1)
    _assert_cp_coords_grad_matches_plain(params, _cp_samples(n, dev, seed=20), dsigma,
                                         flat[1:].view(dapp.shape))


def test_cp_autograd_launches_the_kernels(dev):
    """Under grad: one forward, and on backward one line-gradient launch and,
    with xyz requiring grad, one coordinate launch; the gradients are the
    plain versions'."""
    params = _cp_lines("r5", dev)
    leaves = {k: tuple(a.clone().requires_grad_() for a in v)
              for k, v in params.items()}
    xyz = _cp_samples(1021, dev).requires_grad_()
    before = (cpf.cp_features.launches, cpf.cp_features_backward.launches,
              cpf.cp_features_coords_grad.launches)
    sigma, app = cpf.cp_features(CP_CFG, leaves, xyz)
    (sigma.sum() + app.square().sum()).backward()
    torch.cuda.synchronize()
    assert (cpf.cp_features.launches, cpf.cp_features_backward.launches,
            cpf.cp_features_coords_grad.launches) == tuple(
                b + 1 for b in before)
    with torch.no_grad():
        _, want_app = cpf.cp_features_plain(params, xyz, True,
                                            gather_rows_plain)
    ds = torch.ones(1021, device=dev)
    want = cpf.cp_features_backward_plain(params, xyz, ds, 2 * want_app)
    for k in want:
        for leaf, w in zip(leaves[k], want[k]):
            torch.testing.assert_close(leaf.grad, w, rtol=0, atol=CP_GRAD_TOL
                                       * float(w.abs().max()))
    w = cpf.cp_features_coords_grad_plain(params, xyz, ds, 2 * want_app)
    torch.testing.assert_close(xyz.grad, w, rtol=0,
                               atol=COORDS_GRAD_TOL * float(w.abs().max()))


@pytest.mark.parametrize("take", ["float64_xyz", "strided_line", "vm_field",
                                  "long_lines_under_grad", "ranks_differ",
                                  "upstream_shape"])
def test_cp_wrappers_refuse_before_any_launch(dev, take):
    params = _cp_lines("r5", dev)
    xyz = _cp_samples(63, dev)
    dsigma, dapp = _cp_upstream(params, 63, dev)
    cfg = CP_CFG
    call = "forward"
    if take == "float64_xyz":
        xyz = xyz.double()
    elif take == "strided_line":
        params["app_line"] = (params["app_line"][0][::2], *params["app_line"][1:])
    elif take == "vm_field":
        cfg = FieldConfig()
    elif take == "long_lines_under_grad":
        params = {k: tuple(torch.zeros((12000, 4), device=dev,
                                       requires_grad=True) for _ in range(3))
                  for k in params}
        call = "grad"
    elif take == "ranks_differ":
        params["density_line"] = (params["density_line"][0][:, :3].contiguous(),
                                  *params["density_line"][1:])
    else:
        dapp = dapp[:, :3]
        call = "upstream"
    counts = (cpf.cp_features.launches, cpf.cp_features_backward.launches,
              cpf.cp_features_coords_grad.launches)
    with pytest.raises(ValueError):
        if call == "upstream":
            cpf.cp_features_backward(cfg, params, xyz, dsigma, dapp)
        else:
            cpf.cp_features(cfg, params, xyz)
    if call == "upstream":
        with pytest.raises(ValueError):
            cpf.cp_features_coords_grad(cfg, params, xyz, dsigma, dapp)
    elif take != "long_lines_under_grad":
        with pytest.raises(ValueError):
            cpf.cp_features_backward(cfg, params, xyz, dsigma, dapp)
        with pytest.raises(ValueError):
            cpf.cp_features_coords_grad(cfg, params, xyz, dsigma, dapp)
    assert (cpf.cp_features.launches, cpf.cp_features_backward.launches,
            cpf.cp_features_coords_grad.launches) == counts


def _assert_cp_forward_matches_plain(params, xyz, route):
    """The forward kernel against cp_features_plain (chunked): the products
    bit-equal, sigma within 1e-5 and 1e-6 x max|plain|, a second call
    bit-equal, a density-only call's sigma the same; one launch a call, on
    ``route``."""
    before = dict(cpf.cp_features.launches_by_route)
    with torch.no_grad():
        sigma, app = cpf.cp_features(CP_CFG, params, xyz)
        again = cpf.cp_features(CP_CFG, params, xyz)
        only, none = cpf.cp_features(CP_CFG, params, xyz, with_app=False)
    torch.cuda.synchronize()
    counted = {k: cpf.cp_features.launches_by_route[k] - before[k] for k in before}
    assert counted == {k: 3 * (k == route and xyz.shape[0] > 0) for k in before}
    want_s, want_a = _cp_chunked(lambda x: cpf.cp_features_plain(
        params, x, True, gather_rows_plain), xyz)
    assert torch.equal(app, want_a) and none is None
    atol = 1e-6 * float(want_s.abs().max()) if want_s.numel() else 0.0
    torch.testing.assert_close(sigma, want_s, rtol=1e-5, atol=atol)
    torch.testing.assert_close(only, want_s, rtol=1e-5, atol=atol)
    assert torch.equal(sigma, again[0]) and torch.equal(app, again[1])


@pytest.mark.parametrize("n", [4096 * 1731, 204660, 1024 * 1728])
def test_cp_forward_kernel_at_the_main_paths_counts(dev, n):
    """TensoRF's CP ranks at a training step's, a colour chunk's and an
    iNeRF iteration's sample counts: 32 columns a block, float4 words."""
    params = _cp_lines("lego", dev, seed=11)
    assert cpf.forward_plan([a.shape[0] for a in params["density_line"]]
                            + [96, 288], True) == ("shared", 5)
    _assert_cp_forward_matches_plain(params, _cp_samples(n, dev, seed=11), "shared")


@pytest.mark.parametrize("length,log_cw", [(600, 4), (2000, 3), (4000, 2),
                                           (8000, 1), (17000, 0)])
def test_cp_forward_kernel_narrower_slices(dev, length, log_cw):
    """Lines long enough that the plan takes 16, 8, 4, 2 and 1 columns a
    block (scalar words below 8), at lego's ranks."""
    g = torch.Generator().manual_seed(12)
    params = {k: tuple((0.5 * torch.randn((length + j, r), generator=g)).to(dev)
                       for j in range(3))
              for k, r in (("density_line", 96), ("app_line", 288))}
    dims = [length, length + 1, length + 2, 96, 288]
    assert cpf.forward_plan(dims, True) == ("shared", log_cw)
    _assert_cp_forward_matches_plain(params, _cp_samples(30000, dev, seed=12), "shared")


@pytest.mark.parametrize("lengths,rd,ra", [
    ((129, 64, 37), 7, 13),     # scalar words, a slice of both kinds
    ((300, 17, 90), 33, 31),
    ((61, 250, 9), 96, 288),
    ((50, 60, 70), 4, 12),      # scalar words, 16 columns a block (ranks not multiples of 8)
    ((129, 64, 37), 12, 20),    # scalar words at 32 columns a block
    ((20000, 20000, 20000), 8, 8),  # past FWD_MAX_ROWS: the first design
])
def test_cp_forward_kernel_uneven_lines_and_ranks(dev, lengths, rd, ra):
    g = torch.Generator().manual_seed(13)
    params = {k: tuple((0.5 * torch.randn((length, r), generator=g)).to(dev)
                       for length in lengths)
              for k, r in (("density_line", rd), ("app_line", ra))}
    route = cpf.forward_plan(list(lengths) + [rd, ra], True)[0]
    assert route == ("l1" if sum(lengths) > cpf.FWD_MAX_ROWS else "shared")
    _assert_cp_forward_matches_plain(params, _cp_samples(9000, dev, seed=13), route)


def test_cp_forward_kernel_unaligned_coords_and_lines(dev):
    """Coordinates, then one line, off the 16-byte grid at lego's ranks:
    scalar words at 32 columns a block, at counts around a stage and a
    unit."""
    params = _cp_lines("lego", dev, seed=14)
    for n in (1, 31, 33, 257, 1021):
        buf = _cp_samples(n + 1, dev, seed=14).reshape(-1)
        xyz = buf[1:1 + 3 * n].view(n, 3)
        _assert_cp_forward_matches_plain(params, xyz, "shared")
    line = params["app_line"][1]
    buf = torch.empty(line.numel() + 1, device=dev)
    buf[1:] = line.reshape(-1)
    params["app_line"] = (params["app_line"][0], buf[1:].view(line.shape),
                          params["app_line"][2])
    _assert_cp_forward_matches_plain(params, _cp_samples(5000, dev, seed=14), "shared")


def _assert_cp_coords_grad_matches_plain(params, xyz, dsigma, dapp=None, repeats=1):
    """The coordinate kernel against cp_features_coords_grad_plain (chunked)
    within COORDS_GRAD_TOL of the largest |dxyz|, one launch a call, a
    sample with no upstream exactly 0, ``repeats`` calls bit-equal -> the
    kernel's result."""
    before = cpf.cp_features_coords_grad.launches
    got = cpf.cp_features_coords_grad(CP_CFG, params, xyz, dsigma, dapp)
    torch.cuda.synchronize()
    assert cpf.cp_features_coords_grad.launches == before + (xyz.shape[0] > 0)
    ups = (dsigma,) if dapp is None else (dsigma, dapp)
    want = _cp_chunked(lambda x, *u: cpf.cp_features_coords_grad_plain(
        params, x, *u), xyz, *ups)
    torch.testing.assert_close(got, want, rtol=0, atol=COORDS_GRAD_TOL * max(
        float(want.abs().max()) if want.numel() else 0.0, 1e-30))
    dead = dsigma == 0 if dapp is None else (dsigma == 0) & (dapp == 0).all(-1)
    assert bool((got[dead] == 0).all())
    for _ in range(repeats - 1):
        assert torch.equal(got, cpf.cp_features_coords_grad(CP_CFG, params, xyz,
                                                            dsigma, dapp))
    return got


def test_cp_coords_kernel_at_an_iteration_like_set(dev):
    """Ray-ordered samples at lego's CP ranks with about 3 % live in a run
    along each ray (nearly every stage dead), with and without the
    appearance upstream; three calls bit-equal."""
    params = _cp_lines("lego", dev, seed=21)
    n = 96 * 1728
    xyz = _cp_samples(n, dev, seed=21)
    dsigma, dapp = iteration_upstream(params, n, 21, dev)
    live = float(((dsigma != 0) | (dapp != 0).any(-1)).float().mean())
    assert 0.02 < live < 0.05
    _assert_cp_coords_grad_matches_plain(params, xyz, dsigma, dapp, repeats=3)
    _assert_cp_coords_grad_matches_plain(params, xyz, dsigma, repeats=3)


def test_cp_coords_kernel_all_live(dev):
    """Every upstream word normal at lego's CP ranks: every stage walked;
    three calls bit-equal."""
    params = _cp_lines("lego", dev, seed=22)
    n = 30000
    g = torch.Generator().manual_seed(22)
    dsigma = torch.randn(n, generator=g).to(dev)
    dapp = torch.randn((n, 288), generator=g).to(dev)
    _assert_cp_coords_grad_matches_plain(params, _cp_samples(n, dev, seed=22), dsigma,
                                         dapp, repeats=3)


# the coordinate kernel's edges: 8-sample stages, 64-sample units; a call
# shorter than a stage, ending inside a stage and inside a unit
@pytest.mark.parametrize("n", [5, 333, 3 * 64 + 8])
@pytest.mark.parametrize("name", ["r5", "lego"])
def test_cp_coords_kernel_stage_and_call_edges(dev, name, n):
    """Live samples only at the first and last sample of stages, of units
    and of the call, the rest without upstream."""
    params = _cp_lines(name, dev, seed=23)
    xyz = _cp_samples(n, dev, seed=23)
    dsigma, dapp = _cp_upstream(params, n, dev, seed=23)
    keep = torch.zeros(n, dtype=torch.bool, device=dev)
    for k in (0, 7, 8, 15, 63, 64, 127, 200, 319, 320, 327, 328, n - 1):
        if k < n:
            keep[k] = True
    dsigma[0] = 1.5
    _assert_cp_coords_grad_matches_plain(params, xyz, dsigma * keep, dapp * keep[:, None])


def test_cp_coords_kernel_live_through_one_kind(dev):
    """Samples live through dsigma alone and through one dapp word alone,
    in otherwise dead stages."""
    params = _cp_lines("lego", dev, seed=24)
    n = 1000
    xyz = _cp_samples(n, dev, seed=24)
    dsigma = torch.zeros(n, device=dev)
    dapp = torch.zeros((n, 288), device=dev)
    dsigma[[3, 100, 517]] = torch.tensor([1.0, -2.0, 0.5], device=dev)
    dapp[17, 0] = 1.25
    dapp[250, 287] = -0.75
    dapp[517, 100] = 2.0
    _assert_cp_coords_grad_matches_plain(params, xyz, dsigma, dapp)


def test_cp_coords_kernel_zero_upstream_gives_zero(dev):
    params = _cp_lines("lego", dev, seed=25)
    n = 4097
    xyz = _cp_samples(n, dev, seed=25)
    got = cpf.cp_features_coords_grad(CP_CFG, params, xyz, torch.zeros(n, device=dev),
                                      torch.zeros((n, 288), device=dev))
    assert torch.equal(got, torch.zeros_like(xyz))


def test_cp_coords_kernel_wide_ranks_take_short_stages(dev):
    """Appearance ranks too wide for 8-sample stages take 4; wider than two
    such stages fit are refused before any launch."""
    g = torch.Generator().manual_seed(26)
    params = {k: tuple((0.5 * torch.randn((length, r), generator=g)).to(dev)
                       for length in (40, 50, 60))
              for k, r in (("density_line", 8), ("app_line", 500))}
    assert cpf.coords_plan([40, 50, 60, 8, 500], True)[0] == 4
    n = 5000
    xyz = _cp_samples(n, dev, seed=26)
    _assert_cp_coords_grad_matches_plain(params, xyz, *iteration_upstream(
        params, n, 26, dev, per_ray=500, run=100))
    wide = dict(params, app_line=tuple(torch.zeros((a.shape[0], 900), device=dev)
                                       for a in params["app_line"]))
    before = cpf.cp_features_coords_grad.launches
    with pytest.raises(ValueError):
        cpf.cp_features_coords_grad(CP_CFG, wide, xyz, torch.ones(n, device=dev),
                                    torch.ones((n, 900), device=dev))
    assert cpf.cp_features_coords_grad.launches == before


def _assert_cp_backward_matches_plain(params, xyz, dsigma, dapp=None):
    """The line-gradient kernel against cp_features_backward_plain (chunked)
    within CP_GRAD_TOL of each line's largest, one launch."""
    before = cpf.cp_features_backward.launches
    got = cpf.cp_features_backward(CP_CFG, params, xyz, dsigma, dapp)
    torch.cuda.synchronize()
    assert cpf.cp_features_backward.launches == before + (xyz.shape[0] > 0)
    ups = (dsigma,) if dapp is None else (dsigma, dapp)
    want = _cp_chunked(lambda x, *u: cpf.cp_features_backward_plain(
        params, x, *u), xyz, *ups, total=True)
    assert sorted(got) == sorted(want)
    for k in want:
        for a, b in zip(got[k], want[k]):
            torch.testing.assert_close(a, b, rtol=0, atol=CP_GRAD_TOL * max(
                float(b.abs().max()), 1e-30))


# the backward's edges: a call shorter than one stage (kRun samples a
# group), counts that end inside a stage and inside a unit (BWD_UNIT), and
# a unit and a half
@pytest.mark.parametrize("n", [0, 3, 5, 4097, 1537 + 4 * 1024])
@pytest.mark.parametrize("name", ["r5", "lego"])
def test_cp_backward_kernel_stage_edges(dev, name, n):
    params = _cp_lines(name, dev, seed=4)
    xyz = _cp_samples(n, dev, seed=4)
    _assert_cp_backward_matches_plain(params, xyz, *_cp_upstream(params, n, dev))


def test_cp_backward_kernel_dead_stages(dev):
    """Whole stages and units without upstream (the walk leaves them at
    once), a live sample whose words are zero but one, and a sample whose
    density upstream alone is not zero."""
    params = _cp_lines("lego", dev, seed=5)
    n = 6 * 1024 + 20
    xyz = _cp_samples(n, dev, seed=5)
    dsigma, dapp = _cp_upstream(params, n, dev, seed=5)
    for lo, hi in ((0, 1024), (1030, 1050), (2048, 4096), (5000, 5004)):
        dsigma[lo:hi] = 0
        dapp[lo:hi] = 0
    dsigma[4100] = 0
    dapp[4100] = 0
    dapp[4100, 7] = 1.5
    dapp[4101] = 0
    _assert_cp_backward_matches_plain(params, xyz, dsigma, dapp)


@pytest.mark.parametrize("lengths,rd,ra", [
    ((129, 64, 37), 7, 13),    # ranks not multiples of 4: read from memory
    ((300, 17, 90), 33, 31),   # a slice that holds both kinds
    ((61, 250, 9), 96, 288),   # uneven lines at lego's ranks
])
def test_cp_backward_kernel_uneven_lines_and_ranks(dev, lengths, rd, ra):
    g = torch.Generator().manual_seed(6)
    params = {k: tuple((0.5 * torch.randn((length, r), generator=g)).to(dev)
                       for length in lengths)
              for k, r in (("density_line", rd), ("app_line", ra))}
    xyz = _cp_samples(9000, dev, seed=6)
    _assert_cp_backward_matches_plain(params, xyz, *_cp_upstream(params, 9000, dev))


@pytest.mark.parametrize("kind", ["density", "app"])
def test_cp_backward_kernel_one_kind(dev, kind):
    """A density-only request (no dapp) through the wrapper, and an
    appearance-only one through autograd (the density lines frozen): one
    launch, the wanted lines' gradients the plain version's."""
    params = _cp_lines("lego", dev, seed=7)
    n = 20000
    xyz = _cp_samples(n, dev, seed=7)
    dsigma, dapp = _cp_upstream(params, n, dev, seed=7)
    if kind == "density":
        _assert_cp_backward_matches_plain(params, xyz, dsigma)
        return
    leaves = {"density_line": params["density_line"],
              "app_line": tuple(a.clone().requires_grad_()
                                for a in params["app_line"])}
    before = cpf.cp_features_backward.launches
    _, app = cpf.cp_features(CP_CFG, leaves, xyz)
    (app * dapp).sum().backward()
    torch.cuda.synchronize()
    assert cpf.cp_features_backward.launches == before + 1
    want = cpf.cp_features_backward_plain(params, xyz, torch.zeros_like(dsigma),
                                          dapp)["app_line"]
    for leaf, w in zip(leaves["app_line"], want):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=CP_GRAD_TOL * float(
            w.abs().max()))


def _switch_rows():
    """The lines' sum of rows where the backward's plan at lego's ranks
    first takes fewer than 32 columns a block."""
    rows = 1000
    while cpf.backward_plan((rows, 0, 0, 96, 288), True, True)[0] == 5:
        rows += 1
    return rows


@pytest.mark.parametrize("side", [-1, 0])
def test_cp_backward_kernel_at_the_column_width_switch(dev, side):
    """Lines whose rows sum to the last count at 32 columns a block and to
    the first at 16."""
    rows = _switch_rows() + side
    assert cpf.backward_plan((rows, 0, 0, 96, 288), True, True)[0] == (
        5 if side < 0 else 4)
    lengths = (rows // 3, rows // 3, rows - 2 * (rows // 3))
    g = torch.Generator().manual_seed(8)
    params = {k: tuple((0.5 * torch.randn((length, r), generator=g)).to(dev)
                       for length in lengths)
              for k, r in (("density_line", 96), ("app_line", 288))}
    xyz = _cp_samples(30000, dev, seed=8)
    _assert_cp_backward_matches_plain(params, xyz, *_cp_upstream(params, 30000, dev))


@pytest.mark.parametrize("shape", ["mask", "density_line", "app_line",
                                   "wrapped", "unaligned", "vm_plane",
                                   "long_line", "one_run", "shuffled", "one",
                                   "below_unit"])
def test_gather_backward_kernel_matches_index_add(dev, shape):
    """K3's backward against index_add_ (gather_rows_backward_plain): the
    mask lookup's stacked corners into a [300^3, 1] volume (one lane an
    entry), a CP step's line corners into [500, 96] and [500, 288] lines
    (one and three column slices), wrapped and out-of-range indices (the
    latter add nothing), rows off the 16-byte grid (4-byte words), a VM
    plane [300^2, 48] at 4 corners a sample (12 lanes an entry), a longer
    line ([2500, 96]), every index equal (one run), shuffled indices (runs
    of 1), one entry and fewer entries than a unit holds (a [500, 1]
    line)."""
    g = torch.Generator().manual_seed(5)
    if shape == "mask":
        rows, c = 300 ** 3, 1
        coords = (torch.rand((204660, 3), generator=g) * 2.1 - 1.05).to(dev)
        idx = corners_3d(300, 300, 300, coords)[0].reshape(-1)
    elif shape == "vm_plane":
        rows, c = 300 ** 2, 48
        coords = _cp_samples(204660, dev)[:, :2]
        idx = corners_2d(300, 300, coords)[0].reshape(-1).contiguous()
    else:
        rows, c = {"long_line": (2500, 96), "one_run": (500, 96),
                   "shuffled": (500, 96), "one": (500, 96),
                   "below_unit": (500, 1)}.get(shape, (500, None))
        c = c or {"density_line": 96, "app_line": 288, "wrapped": 16,
                  "unaligned": 16}[shape]
        xyz = _cp_samples(204660, dev)
        idx = corners_1d(rows, xyz[:, 2])[0].reshape(-1).contiguous()
        if shape == "wrapped":
            idx = torch.randint(-rows - 9, rows + 9, idx.shape, generator=g,
                                dtype=torch.int32).to(dev)
        elif shape == "one_run":
            idx = torch.full_like(idx, 123)
        elif shape == "shuffled":
            idx = idx[torch.randperm(idx.shape[0], generator=g).to(dev)]
        elif shape == "one":
            idx = idx[:1].contiguous()
        elif shape == "below_unit":
            idx = idx[:20].contiguous()
    plan = backward_plan(rows, c, idx.shape[0], torch.cuda.get_device_properties(
        dev).multi_processor_count, shape != "unaligned")
    assert plan.slices == -(-c // 96)
    if shape == "below_unit":
        assert idx.shape[0] < plan.unit
    up = torch.randn((idx.shape[0] * c + 1,), generator=g).to(dev)
    # rows off the 16-byte grid: the kernel takes 4-byte words
    up = (up[1:] if shape == "unaligned" else up[:-1]).view(idx.shape[0], c)
    before = gather_rows_backward.launches
    got = gather_rows_backward(up, idx, rows)
    torch.cuda.synchronize()
    assert gather_rows_backward.launches == before + 1
    want = gather_rows_backward_plain(up, idx, rows)
    torch.testing.assert_close(got, want, rtol=0, atol=CP_GRAD_TOL * float(
        want.abs().max()))


def test_gather_backward_refuses_before_any_launch(dev):
    up = torch.zeros((5, 3), device=dev)
    before = gather_rows_backward.launches
    for args in ((up.double(), torch.zeros(5, dtype=torch.int32, device=dev), 4),
                 (up, torch.zeros(5, dtype=torch.int64, device=dev), 4),
                 (up, torch.zeros(5, dtype=torch.int32), 4),
                 (up.t(), torch.zeros(3, dtype=torch.int32, device=dev), 4)):
        with pytest.raises(ValueError):
            gather_rows_backward(*args)
    assert gather_rows_backward.launches == before


@pytest.mark.parametrize("model", ["TensorVMSplit", "TensorCP"])
def test_samplers_route_under_grad_runs_on_the_gather_backward(dev, model):
    """fused_eval "off": the grid samplers on K3 under grad, its backward
    launched on backward; the gradients are the CPU route's."""
    cfg = FieldConfig(model_name=model, grid_size=(40, 36, 32),
                      density_n_comp=(4, 4, 4), app_n_comp=(8, 8, 8),
                      app_dim=12, fused_eval="off")
    params = init_field(torch.Generator().manual_seed(0), cfg)
    xyz = (torch.rand((2000, 3), generator=torch.Generator().manual_seed(1))
           * 2.4 - 1.2)
    grads = {}
    for where in ("cpu", "cuda"):
        leaves = {k: tuple(a.detach().to(where).clone().requires_grad_()
                           for a in v)
                  for k, v in params.items() if k.endswith(("_line", "_plane"))}
        p = dict(params, **leaves, basis_mat={
            "w": params["basis_mat"]["w"].to(where)})
        before = gather_rows_backward.launches
        sigma, app = compute_features(cfg, p, xyz.to(where))
        (sigma.square().sum() + app.sum()).backward()
        if where == "cuda":
            torch.cuda.synchronize()
            assert gather_rows_backward.launches > before
        grads[where] = {k: [a.grad.cpu() for a in v] for k, v in leaves.items()}
    for k, want in grads["cpu"].items():
        for a, b in zip(grads["cuda"][k], want):
            torch.testing.assert_close(a, b, rtol=0, atol=CP_GRAD_TOL * float(
                b.abs().max()))
