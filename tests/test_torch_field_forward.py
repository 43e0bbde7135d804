"""field_features' forward and its coordinate gradient on ray-ordered
samples, the layout their kernels walk: the plain version against the JAX
package, and numpy models of the kernels' walks against the plain
versions.

On the card the forward kernel is held to ``field_features_plain``
(``tests/test_torch_cuda_kernels.py``). Here (a) that plain version is held
to the JAX package's ``compute_densityfeature`` and ``compute_appfeature``
(an identity ``basis_mat``, so that the appearance products themselves are
compared) on rays in the order training samples them, half a texel apart,
along the axes, the diagonals and both, leaving [-1, 1]: rtol 1e-5 and an
atol of 1e-6 x max|JAX| (float32 in another order, as
``test_torch_field_fused.py`` holds the fused features). (b) The kernel's
walk (``tools/ff_time.py::walk_forward``: runs of consecutive samples, a
group of lanes a run and axis pair, corner rows kept in slots by parity,
only the rows a cell enters read, the products in the samplers' order) is
held bit-equal to the plain version's appearance products and to its sigma
within that tolerance, at sample counts around the kernel's longest run
read from its source (ray ends inside runs), in float4 and 4-byte words;
its row count to ``row_fetches``; the host's run-length rule
(``forward_plan``) to the split the kernel's design names. (c) The
coordinate kernel's walk (``tools/ff_time.py::walk_coords_grad``: a sample
live when its upstream row has a word that is not zero, each run's live
samples walked in order with the forward's slots, the derivatives' signs
by the cell's parity) is held to ``field_features_coords_grad_plain``
within COORDS_GRAD_TOL of the largest |dxyz|, samples without upstream
exactly 0, on rays whose upstream has dead samples and dead runs, at the
kernel's run length read from its source. A 32^3 field with unequal
ranks; tables and inputs from numpy seeds.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iffnerf_tpu.models import field as jfield
from iffnerf_tpu_torch.ops import field_features as tff
from iffnerf_tpu_torch.tools.ff_time import (
    AXES,
    DIAGONALS,
    forward_plan,
    ray_ordered_samples,
    ray_upstream,
    row_fetches,
    run_samples,
    walk_coords_grad,
    walk_forward,
)

GRID = (32, 32, 32)
ROUTES = {"float4": ((4, 8, 12), (8, 12, 16)), "scalar": ((2, 3, 5), (3, 6, 4))}
PER_RAY = 2 * max(GRID) + 37  # about two grid widths: in, across and out
N = 808
LAYOUTS = {"axes": (AXES, 5), "diagonals": (DIAGONALS, 11),
           "rays": (AXES + DIAGONALS, 17)}
RUN = run_samples(Path(__file__).resolve().parents[1], "kMaxRun")
COORD_RUN = run_samples(Path(__file__).resolve().parents[1], "kCoordRun")
TOL = dict(rtol=1e-5, atol=1e-6)
# the coordinate gradient against autograd's through the samplers, of the
# largest |dxyz|: each coordinate sums up to 3 x (Rd + Ra) rank terms in
# another order (the card's rule, chip_smoke.COORDS_GRAD_TOL)
COORDS_GRAD_TOL = 1e-4


def _tables(density, app, seed):
    """The four table kinds (planes [H, W, R], lines [L, R]) as numpy
    float32, normal around 0.5."""
    rng = np.random.default_rng(seed)
    params = {}
    for kind, ranks in (("density", density), ("app", app)):
        params[f"{kind}_plane"] = tuple(
            (0.5 + 0.1 * rng.standard_normal((GRID[m1], GRID[m0], ranks[i])))
            .astype(np.float32) for i, (m0, m1) in enumerate(tff.MAT_MODE))
        params[f"{kind}_line"] = tuple(
            (0.5 + 0.1 * rng.standard_normal((GRID[tff.VEC_MODE[i]], ranks[i])))
            .astype(np.float32) for i in range(3))
    return params


@pytest.fixture(scope="module", params=sorted(ROUTES))
def route(request):
    """(route name, numpy tables, the same as torch tensors)."""
    params = _tables(*ROUTES[request.param], seed=9)
    port = {k: tuple(torch.from_numpy(a) for a in params[k]) for k in tff.TABLES}
    return request.param, params, port


def _samples(layout, n):
    """``n`` samples of rays in the layout's directions, ray-major."""
    dirs, seed = LAYOUTS[layout]
    rounds = -(-n // (PER_RAY * len(dirs)))
    return np.concatenate([ray_ordered_samples(GRID, dirs, PER_RAY, seed + k,
                                               spread=0.9)
                           for k in range(rounds)])[:n]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"],
                               atol=TOL["atol"] * float(np.abs(want).max()))


@pytest.mark.parametrize("with_app", [True, False])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plain_matches_jax_on_rays(route, layout, with_app):
    """field_features_plain against compute_densityfeature and, with an
    identity basis_mat, compute_appfeature."""
    _, params, port = route
    xyz = _samples(layout, N)
    assert (np.abs(xyz) > 1).any()
    width = sum(a.shape[-1] for a in params["app_plane"])
    config = jfield.FieldConfig(
        grid_size=GRID, density_n_comp=tuple(a.shape[-1] for a in params["density_plane"]),
        app_n_comp=tuple(a.shape[-1] for a in params["app_plane"]), app_dim=width)
    jp = dict(params, basis_mat={"w": np.eye(width, dtype=np.float32)})
    sigma, app = tff.field_features_plain(port, torch.from_numpy(xyz), with_app)
    _close(sigma.numpy(), jfield.compute_densityfeature(config, jp, jnp.asarray(xyz)))
    if with_app:
        _close(app.numpy(), jfield.compute_appfeature(config, jp, jnp.asarray(xyz)))
    else:
        assert app is None


@pytest.mark.parametrize("n", [RUN - 1, RUN, RUN + 1, 2 * RUN + 1, N])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_walk_model_matches_plain(route, layout, n):
    """The walk over runs of the kernel's longest run: appearance products
    bit-equal to the plain version's, sigma within TOL, density-only and
    with appearance; rows read as row_fetches counts them."""
    name, _, port = route
    xyz = _samples(layout, n)
    want_sigma, want_app = tff.field_features_plain(port, torch.from_numpy(xyz))
    sigma, app, fetched = walk_forward(port, xyz, True, name == "float4", RUN)
    assert app.shape == tuple(want_app.shape)
    assert np.array_equal(app, want_app.numpy())
    _close(sigma, want_sigma.numpy())
    dens, none, _ = walk_forward(port, xyz, False, name == "float4", RUN)
    assert none is None
    _close(dens, want_sigma.numpy())
    count = row_fetches(port, torch.from_numpy(xyz), RUN)
    assert fetched == count["new"]
    assert count["old"] == 18 * n


@pytest.mark.parametrize("run", [1, 8, 16])
def test_walk_model_at_shorter_runs(route, run):
    """The runs the host's rule falls back to for small calls, down to a
    run of 1 (every sample reads all its corners): bit-equal products, and
    a run of 1 reads 6 rows a sample and pair."""
    name, _, port = route
    xyz = _samples("rays", N)
    _, want_app = tff.field_features_plain(port, torch.from_numpy(xyz))
    _, app, fetched = walk_forward(port, xyz, True, name == "float4", run)
    assert np.array_equal(app, want_app.numpy())
    assert fetched == row_fetches(port, torch.from_numpy(xyz), run)["new"]
    if run == 1:
        assert fetched == 18 * N


def test_walk_reads_fewer_rows_on_rays():
    """On half-texel rays a run of 32 reads far fewer corner rows than 6 a
    sample and pair; on axis-aligned rays fewer still (the pierced plane
    keeps its cell for the whole run)."""
    port = {k: tuple(torch.from_numpy(a) for a in v)
            for k, v in _tables(*ROUTES["float4"], seed=9).items()}
    mixed = row_fetches(port, torch.from_numpy(_samples("diagonals", N)), RUN)
    axes = row_fetches(port, torch.from_numpy(_samples("axes", N)), RUN)
    assert mixed["factor"] > 2.0
    assert axes["factor"] > mixed["factor"]


def _lego_dims(with_app):
    """kernel_layout's dims at lego's ranks (the split reads no grid size)."""
    tables = {f"{kind}_{part}": tuple(
        np.zeros(((4, 4, r) if part == "plane" else (4, r)), np.float32)
        for _ in range(3))
        for kind, r in (("density", 16), ("app", 48)) for part in ("plane", "line")}
    return tff.kernel_layout(tables, with_app)[1]


def test_forward_plan_at_lego_ranks():
    """The host's split at lego's ranks: groups of 16 lanes (float4) a run
    and axis pair, 3 parts, 6 warps holding 4 runs, the density sums of 4
    lanes a group kept; runs of 32 at a training step's 4.2 M samples, shorter
    runs as a call gets smaller (4 spans for each resident block), a run
    of 1 for a handful of samples;
    density-only groups of 4 lanes, 8 runs a block of 3 warps (shared
    memory caps them); 4-byte words in 2 groups a pair."""
    dims = _lego_dims(True)
    resident = 132 * 3
    step = forward_plan(dims, True, 4_239_360, resident)
    assert (step["g"], step["parts"], step["warps"], step["runs"],
            step["red"], step["run"]) == (16, 3, 6, 4, 4, RUN)
    full = 132 * tff.BLOCKS_PER_SM  # the grid's cap: as many as may be resident
    chunk = forward_plan(dims, True, 204_660, full)
    assert 1 < chunk["run"] < RUN
    assert chunk["spans"] >= 4 * full > -(-204_660 // (chunk["runs"] * 2 * chunk["run"]))
    assert forward_plan(dims, True, 5, resident)["run"] == 1
    dens = forward_plan(_lego_dims(False), True, 4_239_360, resident)
    assert (dens["g"], dens["parts"], dens["warps"], dens["runs"]) == (4, 3, 3, 8)
    assert dens["runs"] * (3 * 64 + 3 * 4 * dens["red"]) * RUN <= 64 * 1024
    scalar = forward_plan(dims, False, 4_239_360, resident)
    assert (scalar["g"], scalar["parts"], scalar["runs"], scalar["red"]) == (32, 6, 1, 16)


@pytest.mark.parametrize("with_app", [True, False])
@pytest.mark.parametrize("n", [5 * COORD_RUN + 1, N])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_coords_walk_model_matches_plain(route, layout, n, with_app):
    """The coordinate kernel's walk against field_features_coords_grad_plain
    on rays with dead samples inside runs and dead runs (``ray_upstream``),
    density-only and with appearance: within COORDS_GRAD_TOL, a sample
    without upstream exactly 0."""
    _, _, port = route
    xyz = _samples(layout, n)
    width = sum(a.shape[-1] for a in port["app_plane"])
    dsigma, dapp = ray_upstream(n, width, 3)
    if not with_app:
        dapp = None
    live = dsigma != 0
    if with_app:
        live = live | (dapp != 0).any(-1)
    assert 0 < live.sum() < n
    want = tff.field_features_coords_grad_plain(
        port, torch.from_numpy(xyz), torch.from_numpy(dsigma),
        None if dapp is None else torch.from_numpy(dapp)).numpy()
    got, _ = walk_coords_grad(port, xyz, dsigma, dapp, COORD_RUN)
    np.testing.assert_allclose(got, want, rtol=0, atol=COORDS_GRAD_TOL
                               * float(np.abs(want).max()))
    assert not got[~live].any()


def test_coords_walk_reads_fewer_rows_on_rays():
    """Runs of the kernel's length read fewer corner rows than 18 a live
    sample on half-texel rays; runs of 1 read exactly 18."""
    port = {k: tuple(torch.from_numpy(a) for a in v)
            for k, v in _tables(*ROUTES["float4"], seed=9).items()}
    xyz = _samples("diagonals", N)
    dsigma, dapp = ray_upstream(N, sum(a.shape[-1] for a in port["app_plane"]), 4)
    live = int(((dsigma != 0) | (dapp != 0).any(-1)).sum())
    _, walked = walk_coords_grad(port, xyz, dsigma, dapp, COORD_RUN)
    _, alone = walk_coords_grad(port, xyz, dsigma, dapp, 1)
    assert alone == 18 * live
    assert walked < 0.6 * alone


@pytest.mark.parametrize("table", ["_VARIANTS", "_FWD_VARIANTS", "_COORD_VARIANTS"])
def test_ff_time_variants_edit_the_source(table):
    """Every text edit of ``tools/ff_time.py``'s variants of this
    checkout's kernels (the backward's, the forward's walk and the
    coordinate kernel's) finds its text exactly once in
    ``csrc/field_features.cu``, so that each variant builds."""
    import iffnerf_tpu_torch.tools.ff_time as ff_time

    src = (Path(__file__).resolve().parents[1] / "iffnerf_tpu_torch" / "csrc"
           / "field_features.cu").read_text()
    for name, spec in getattr(ff_time, table).items():
        if table == "_FWD_VARIANTS" and spec[0] != "source":
            continue
        edits = spec[1] if table == "_FWD_VARIANTS" else spec[0]
        for old, _ in edits:
            assert src.count(old) == 1, (name, old[:60])
