"""The TensorCP route of the port's field kernels against the JAX package,
on the CPU: ``ops/cp_features.py``'s plain versions (the kernel's function,
its line gradient and its coordinate gradient) against the JAX package's
``compute_densityfeature`` and ``compute_appfeature`` for CP (``basis_mat``
the identity, so that the appearance feature is the products) and
``jax.vjp`` of them; K3's plain backward against ``jax.vjp`` of
``jnp.take``; the dispatch rule ``use_cp_kernel``; the wrappers' refusals;
the kernels' plans, and models of the forward's lerp and of the
coordinate gradient's records and walk against the plain versions; the
timing tool's text edits. The kernels themselves run on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py).

Inputs are drawn by numpy from a seed. Tolerances: the forward within rtol
1e-5 (sigma's sum over ranks in another order; the products are the same
float32 operations); the gradients within 1e-5 of the largest (float32
sums of up to a few hundred terms in another order).
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (torch on one thread)
from iffnerf_tpu.models import field as jfield
from iffnerf_tpu_torch.models import field as tfield
from iffnerf_tpu_torch.ops import cp_features as cpf
from iffnerf_tpu_torch.ops.grid_sample import corners_1d
from iffnerf_tpu_torch.ops.gather import (
    gather_rows,
    gather_rows_backward,
    gather_rows_backward_plain,
)
from iffnerf_tpu_torch.tools import cp_time

FIELDS = {"cubic": ((20, 20, 20), 3, 5), "uneven": ((16, 17, 18), 4, 12)}
GRAD_TOL = 1e-5


def _case(name, seed=0, n=300):
    """(lines as numpy, xyz [n, 3] in and beyond [-1, 1], dsigma, dapp)."""
    (gx, gy, gz), rd, ra = FIELDS[name]
    rng = np.random.default_rng(seed)
    lengths = (gz, gy, gx)  # line i is indexed by xyz[2 - i]
    lines = {k: tuple(rng.standard_normal((length, r)).astype(np.float32)
                      for length in lengths)
             for k, r in (("density_line", rd), ("app_line", ra))}
    xyz = rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
    xyz[:8] = np.array([-1.0, 1.0, 0.0], np.float32)[rng.integers(0, 3, (8, 3))]
    dsigma = rng.standard_normal(n).astype(np.float32)
    dapp = rng.standard_normal((n, ra)).astype(np.float32)
    return lines, xyz, dsigma, dapp


def _configs(name):
    (gx, gy, gz), rd, ra = FIELDS[name]
    kw = dict(model_name="TensorCP", grid_size=(gx, gy, gz),
              density_n_comp=(rd,) * 3, app_n_comp=(ra,) * 3, app_dim=ra)
    return jfield.FieldConfig(**kw), tfield.FieldConfig(**kw)


def _jax_features(jcfg, lines, ra):
    """The JAX package's CP features as a function of (density lines, app
    lines, xyz): (sigma, the app products through an identity basis_mat)."""
    eye = jnp.eye(ra, dtype=jnp.float32)

    @jax.jit  # one compilation in place of op-by-op dispatch
    def fn(dens, app, xyz):
        params = {"density_line": dens, "app_line": app,
                  "basis_mat": {"w": eye}}
        return (jfield.compute_densityfeature(jcfg, params, xyz),
                jfield.compute_appfeature(jcfg, params, xyz))
    return fn


def _t(tree):
    return {k: tuple(torch.from_numpy(a) for a in v) for k, v in tree.items()}


@pytest.mark.parametrize("name", list(FIELDS))
def test_cp_plain_forward_matches_jax(name):
    lines, xyz, _, _ = _case(name)
    jcfg, tcfg = _configs(name)
    ra = FIELDS[name][2]
    want_s, want_a = _jax_features(jcfg, lines, ra)(
        lines["density_line"], lines["app_line"], jnp.asarray(xyz))
    sigma, app = cpf.cp_features(tcfg, _t(lines), torch.from_numpy(xyz))
    np.testing.assert_allclose(sigma.numpy(), np.asarray(want_s), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(app.numpy(), np.asarray(want_a), rtol=1e-5,
                               atol=1e-6)
    # density only, and the route compute_features takes on the CPU
    only, none = cpf.cp_features(tcfg, _t(lines), torch.from_numpy(xyz),
                                 with_app=False)
    assert none is None and torch.equal(only, sigma)


@pytest.mark.parametrize("name", list(FIELDS))
@pytest.mark.parametrize("with_app", [False, True])
def test_cp_plain_gradients_match_jax_vjp(name, with_app):
    lines, xyz, dsigma, dapp = _case(name, seed=1)
    jcfg, tcfg = _configs(name)
    ra = FIELDS[name][2]
    fn = _jax_features(jcfg, lines, ra)
    _, vjp = jax.vjp(fn, lines["density_line"], lines["app_line"],
                     jnp.asarray(xyz))
    up_app = dapp if with_app else np.zeros_like(dapp)
    g_dens, g_app, g_xyz = vjp((jnp.asarray(dsigma), jnp.asarray(up_app)))
    tl = _t(lines)
    t_dapp = torch.from_numpy(dapp) if with_app else None
    got = cpf.cp_features_backward(tcfg, tl, torch.from_numpy(xyz),
                                   torch.from_numpy(dsigma), t_dapp)
    want = {"density_line": g_dens, "app_line": g_app}
    assert set(got) == ({"density_line", "app_line"} if with_app
                        else {"density_line"})
    for k in got:
        for a, b in zip(got[k], want[k]):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=GRAD_TOL * np.abs(b).max())
    dxyz = cpf.cp_features_coords_grad(tcfg, tl, torch.from_numpy(xyz),
                                       torch.from_numpy(dsigma), t_dapp)
    g_xyz = np.asarray(g_xyz)
    np.testing.assert_allclose(dxyz.numpy(), g_xyz, rtol=0,
                               atol=GRAD_TOL * np.abs(g_xyz).max())


def test_cp_autograd_on_the_cpu_is_the_plain_gradient():
    """The CPU route is torch's autograd through the samplers: the same
    gradients as the plain backward wrappers."""
    lines, xyz, dsigma, dapp = _case("uneven", seed=2)
    _, tcfg = _configs("uneven")
    leaves = {k: tuple(torch.from_numpy(a).requires_grad_() for a in v)
              for k, v in lines.items()}
    pts = torch.from_numpy(xyz).requires_grad_()
    sigma, app = cpf.cp_features(tcfg, leaves, pts)
    (sigma * torch.from_numpy(dsigma)).sum().backward(retain_graph=True)
    (app * torch.from_numpy(dapp)).sum().backward()
    want = cpf.cp_features_backward_plain(_t(lines), torch.from_numpy(xyz),
                                          torch.from_numpy(dsigma),
                                          torch.from_numpy(dapp))
    for k in want:
        for leaf, w in zip(leaves[k], want[k]):
            torch.testing.assert_close(leaf.grad, w, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(pts.grad, cpf.cp_features_coords_grad_plain(
        _t(lines), torch.from_numpy(xyz), torch.from_numpy(dsigma),
        torch.from_numpy(dapp)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fused_eval", ["auto", "on", "off"])
def test_cp_compute_features_on_the_cpu_is_the_plain_route(fused_eval):
    lines, xyz, _, _ = _case("cubic", seed=3)
    _, tcfg = _configs("cubic")
    tcfg = tcfg.replace(fused_eval=fused_eval, app_dim=7)
    params = dict(_t(lines), basis_mat={"w": torch.from_numpy(
        np.random.default_rng(4).standard_normal((5, 7)).astype(np.float32))})
    x = torch.from_numpy(xyz)
    sigma, app = tfield.compute_features(tcfg, params, x)
    want_s, want_p = cpf.cp_features_plain(params, x)
    assert torch.equal(sigma, want_s)
    assert torch.equal(app, want_p @ params["basis_mat"]["w"])
    assert torch.equal(tfield.compute_densityfeature(tcfg, params, x), want_s)
    assert torch.equal(tfield.compute_appfeature(tcfg, params, x), app)


@pytest.mark.parametrize("model,fused_eval,device,want", [
    ("TensorCP", "auto", "cpu", False), ("TensorCP", "auto", "cuda", True),
    ("TensorCP", "on", "cuda", True), ("TensorCP", "off", "cuda", False),
    ("TensorCP", "auto", "meta", False), ("TensorCP", "on", "cpu", False),
    ("TensorVMSplit", "auto", "cuda", False),
    ("TensorVMSplit", "on", "cpu", False),
])
def test_use_cp_kernel(model, fused_eval, device, want):
    """The CP kernel on CUDA unless fused_eval is "off"; never for VM,
    whose kernel use_fused_eval decides (never for CP)."""
    cfg = tfield.FieldConfig(model_name=model, fused_eval=fused_eval)
    assert tfield.use_cp_kernel(cfg, device) is want
    assert tfield.use_cp_kernel(cfg, torch.device(device)) is want
    if model == "TensorCP":
        assert tfield.use_fused_eval(cfg, device) is False


@pytest.mark.parametrize("take", [
    "vm_field", "float64_xyz", "bad_xyz_shape", "float64_line",
    "strided_line", "ranks_differ", "lengths_differ", "meta_device"])
def test_cp_features_refuses_before_any_launch(take):
    lines, xyz, _, _ = _case("uneven", seed=5, n=17)
    _, tcfg = _configs("uneven")
    params, x = _t(lines), torch.from_numpy(xyz)
    if take == "vm_field":
        tcfg = tcfg.replace(model_name="TensorVMSplit")
    elif take == "float64_xyz":
        x = x.double()
    elif take == "bad_xyz_shape":
        x = x[:, :2]
    elif take == "float64_line":
        params["app_line"] = (params["app_line"][0].double(),
                              *params["app_line"][1:])
    elif take == "strided_line":
        params["density_line"] = (params["density_line"][0][::2],
                                  *params["density_line"][1:])
    elif take == "ranks_differ":
        params["app_line"] = (params["app_line"][0][:, :5],
                              *params["app_line"][1:])
    elif take == "lengths_differ":
        params["app_line"] = (params["app_line"][0][:-1].contiguous(),
                              *params["app_line"][1:])
    else:
        x = x.to("meta")
        params = {k: tuple(a.to("meta") for a in v)
                  for k, v in params.items()}
    before = cpf.cp_features.launches
    with pytest.raises(ValueError):
        if take in ("ranks_differ", "lengths_differ"):
            cpf.kernel_layout(params, True)
        else:
            cpf.cp_features(tcfg, params, x)
    assert cpf.cp_features.launches == before


@pytest.mark.parametrize("dims,want_d,want_a,log_cw,stages", [
    ((20, 20, 20, 3, 5), True, True, 3, 4),          # 8 columns cover 8 ranks
    ((412, 412, 412, 96, 288), True, True, 5, 4),    # 1 236 rows: 4 stages
    ((413, 412, 412, 96, 288), True, True, 5, 3),    # 1 237: 3 stages
    ((505, 505, 489, 96, 288), True, True, 5, 2),    # lego's CP step
    ((500, 480, 520, 96, 288), True, True, 5, 2),
    ((509, 509, 508, 96, 288), True, True, 5, 2),    # 1 526: the last at 32 columns
    ((509, 509, 509, 96, 288), True, True, 4, 4),    # 1 527: 16 columns
    ((500, 480, 520, 96, 288), True, False, 5, 2),
    ((130, 140, 150, 1, 1), True, False, 0, 4),
    ((100, 100, 100, 47, 5), False, True, 3, 4),
    ((9000, 9000, 9000, 96, 288), True, True, 0, 4),
    ((4000, 4000, 4000, 96, 288), True, True, 1, 4),
    ((28672, 0, 0, 96, 288), True, True, 0, 4),      # the longest lines taken
])
def test_cp_backward_columns(dims, want_d, want_a, log_cw, stages):
    """A block's column slice and its warps' ring depth: the widest power
    of two up to 32, no wider than the columns asked for, whose sums of the
    three lines and rings fit MAX_SMEM, at the deepest ring that fits."""
    got = cpf.backward_plan(dims, want_d, want_a)
    assert got == (log_cw, stages)
    assert cpf.backward_smem(sum(dims[:3]), *got) <= cpf.MAX_SMEM


def test_cp_backward_refuses_lines_too_long_for_shared_memory():
    with pytest.raises(ValueError, match="shared"):
        cpf.backward_plan((10000, 10000, 10000, 4, 4), True, True)


def _parent_accepts(dims):
    """The first design's rule: one column of the three lines' sums in
    112 KB (two blocks an SM)."""
    return sum(dims[:3]) * 4 <= 112 * 1024


@pytest.mark.parametrize("ranks", [(1, 1), (5, 5), (47, 5), (96, 288),
                                   (400, 400)])
def test_cp_backward_plan_takes_what_the_first_design_took(ranks):
    """Every line length the first design's plan took is still taken, for
    each kind asked for, and the plan's sums and rings fit a block's 227
    KB; one row more than the first design took is refused."""
    rows = sorted({1, 3, 64, 500, 1236, 1237, 1499, 1526, 1527, 3000, 6000,
                   12000, 20000, 28000, 28671, 28672})
    for total in rows:
        dims = (total - total // 2, total // 2, 0) + ranks
        assert _parent_accepts(dims)
        for want_d, want_a in ((True, True), (True, False), (False, True)):
            log_cw, stages = cpf.backward_plan(dims, want_d, want_a)
            cols = (ranks[0] if want_d else 0) + (ranks[1] if want_a else 0)
            assert 0 <= log_cw <= 5 and (log_cw == 0 or 1 << (log_cw - 1) < cols)
            assert stages in cpf.BWD_STAGES
            assert cpf.backward_smem(total, log_cw, stages) <= cpf.MAX_SMEM
    too_long = (28673, 0, 0) + ranks
    assert not _parent_accepts(too_long)
    with pytest.raises(ValueError):
        cpf.backward_plan(too_long, True, True)


@pytest.mark.parametrize("n,slices,sms,want", [
    (7_090_176, 12, 132, 11), (7_090_176, 24, 132, 5), (1021, 1, 132, 1),
    (0, 3, 132, 1), (100_000, 1, 132, 7), (10 ** 9, 1, 132, 132),
    (204_660, 12, 132, 11), (10 ** 9, 400, 132, 1)])
def test_cp_backward_chunks(n, slices, sms, want):
    """One wave of one block an SM (whole slices' worth), no more blocks
    than give each warp a unit of samples, at least one."""
    assert cpf.chunks(n, slices, sms, cpf.BWD_UNIT, cpf.BWD_WARPS) == want


@pytest.mark.parametrize("rows,cols", [(9, 4), (30, 1)])
def test_gather_rows_backward_plain_matches_jax_take_vjp(rows, cols):
    """jnp.take's rule: -R <= i < 0 wraps, anything else outside [0, R)
    gives a NaN row, whose upstream XLA's scatter drops."""
    rng = np.random.default_rng(rows)
    table = rng.standard_normal((rows, cols)).astype(np.float32)
    idx = rng.integers(-rows - 3, rows + 3, 64).astype(np.int32)
    idx[:4] = [0, rows - 1, -1, -rows]
    up = rng.standard_normal((64, cols)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jnp.take(t, jnp.asarray(idx), axis=0), table)
    (want,) = vjp(jnp.asarray(up))
    got = gather_rows_backward(torch.from_numpy(up), torch.from_numpy(idx),
                               rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(got, gather_rows_backward_plain(
        torch.from_numpy(up), torch.from_numpy(idx), rows))
    # autograd through the CPU forward gives the same gradient
    leaf = torch.from_numpy(table).requires_grad_()
    out = gather_rows(leaf, torch.from_numpy(idx))
    ok = torch.isfinite(out).all(-1)
    (out[ok] * torch.from_numpy(up)[ok]).sum().backward()
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("take", ["float64", "idx_int64", "idx_count",
                                  "rows_zero"])
def test_gather_rows_backward_refuses(take):
    up, idx, rows = torch.zeros((5, 3)), torch.zeros(5, dtype=torch.int32), 4
    if take == "float64":
        up = up.double()
    elif take == "idx_int64":
        idx = idx.long()
    elif take == "idx_count":
        idx = idx[:4]
    else:
        rows = 0
    with pytest.raises(ValueError):
        gather_rows_backward(up, idx, rows)


@pytest.mark.parametrize("name", sorted(
    n for n, v in cp_time.VARIANTS.items() if v[0] == "source"))
def test_cp_time_variants_edit_the_source(name):
    """Each text edit of ``tools/cp_time.py``'s variants of this checkout's
    line-gradient or forward kernel finds its text exactly once."""
    src = (Path(cpf.__file__).resolve().parents[1] / "csrc"
           / "cp_features.cu").read_text()
    text = cp_time.variant_source(name, src, None)
    assert (text == src) == (not cp_time.VARIANTS[name][1])


def test_cp_time_parent_plan_is_the_first_designs():
    """The first design's plan at a lego CP step: 16 columns a block, 22
    chunks (four blocks an SM in all over 24 slices)."""
    assert cp_time.parent_plan([505, 505, 489, 96, 288], 384, 7_090_176,
                               132) == (4, 22)
    assert cp_time.parent_plan([20, 20, 20, 3, 5], 8, 1021, 132) == (3, 1)


@pytest.mark.parametrize("name", sorted(
    n for n, v in cp_time.VARIANTS.items() if v[0] == "parent" and cp_time.is_forward(n)))
def test_cp_time_parent_variants_edit_the_first_design(name):
    """The parent's forward cut-outs edit the first design, which the
    source keeps as its long-line route: each edit finds its text there
    exactly once. The source's line gradient is not the first design, so
    ``--parent`` at this checkout runs its backward through the wrapper."""
    src = (Path(cpf.__file__).resolve().parents[1] / "csrc"
           / "cp_features.cu").read_text()
    assert cp_time.variant_source(name, None, src) != src
    assert not cp_time.first_backward(src)


@pytest.mark.parametrize("name,registers,warps", [
    ("_ZN3iff2cp3fwd22cp_features_fwd_kernelILi8ELi2EEEvPKfNS0_5LinesE", 112, 16),
    ("_ZN3iff2cp18cp_features_kernelILi4EEEvPKfNS0_5LinesEPfS4_li", 66, 24),
    ("_ZN3iff2cp3bwd22cp_features_bwd_kernelEPKfS3_S3_", 128, 16),
    ("_ZN3iff2cp19cp_sigma_sum_kernelEPKfPfil", 16, 64),
])
def test_cp_time_resident_warps_by_kernel(name, registers, warps):
    """Each kernel's warps an SM at its own block's threads: 512 for the
    shared forward and the line gradient, 256 for the rest."""
    assert cp_time.kernels_resident_warps({name: registers}) == {name: warps}


@pytest.mark.parametrize("dims,with_app,route,log_cw", [
    ((505, 505, 489, 96, 288), True, "shared", 5),     # lego's CP step
    ((505, 505, 489, 96, 288), False, "shared", 5),    # density only: 96 columns
    ((20, 20, 20, 3, 5), True, "shared", 3),           # 8 columns
    ((16, 17, 18, 4, 12), True, "shared", 4),          # 16 columns
    ((130, 140, 150, 47, 5), True, "shared", 5),       # odd ranks
    ((130, 140, 150, 1, 1), False, "shared", 0),       # one column
    ((542, 541, 541, 96, 288), True, "shared", 5),     # 1 624 rows: the last at 32
    ((542, 542, 541, 96, 288), True, "shared", 4),     # 1 625 rows: 16 columns
    ((4000, 4000, 4000, 96, 288), True, "shared", 2),
    ((9000, 9000, 9000, 96, 288), True, "shared", 0),
    ((17323, 17323, 17322, 96, 288), True, "shared", 0),  # FWD_MAX_ROWS
    ((17323, 17323, 17323, 96, 288), True, "l1", None),   # one row more
    ((60000, 0, 0, 4, 4), False, "l1", None),
])
def test_cp_forward_plan(dims, with_app, route, log_cw):
    """The forward's route and column width: the widest power of two up to
    32, no wider than the columns, whose slice of the three lines fits
    MAX_SMEM beside the warps' records; the first design past
    FWD_MAX_ROWS rows in all."""
    assert cpf.forward_plan(dims, with_app) == (route, log_cw)
    rows = sum(dims[:3])
    assert (route == "shared") == (rows <= cpf.FWD_MAX_ROWS)
    if route == "shared":
        assert cpf.forward_smem(rows, log_cw) <= cpf.MAX_SMEM
        assert log_cw == 5 or cpf.forward_smem(rows, log_cw + 1) > cpf.MAX_SMEM \
            or 1 << log_cw >= dims[3] + (dims[4] if with_app else 0)


def test_cp_forward_plan_at_lego_slices():
    """lego's CP step: 12 slices of 32 columns, 3 of them density, 11
    blocks a slice (one an SM of 132), 216 448 bytes of shared memory."""
    dims = (505, 505, 489, 96, 288)
    _, log_cw = cpf.forward_plan(dims, True)
    slices = -(-(96 + 288) >> log_cw)
    assert (slices, -(-96 >> log_cw)) == (12, 3)
    assert cpf.chunks(7_090_176, slices, 132, cpf.FWD_UNIT, cpf.FWD_WARPS) == 11
    assert cpf.forward_smem(1499, log_cw) == 216_448


@pytest.mark.parametrize("n,slices,sms,want", [
    (7_090_176, 12, 132, 11), (204_660, 12, 132, 11), (1_769_472, 3, 132, 44),
    (1021, 3, 132, 2), (0, 12, 132, 1), (40_000, 1, 132, 79),
    (10 ** 9, 400, 132, 1)])
def test_cp_forward_chunks(n, slices, sms, want):
    """One wave of one block an SM, no more blocks than give each warp a
    unit of FWD_UNIT samples, at least one."""
    assert cpf.chunks(n, slices, sms, cpf.FWD_UNIT, cpf.FWD_WARPS) == want


@pytest.mark.parametrize("dims,log_cw,aligned,want", [
    ((505, 505, 489, 96, 288), 5, True, 8),   # lego's CP step: two float4 a lane
    ((505, 505, 489, 96, 288), 5, False, 1),  # a pointer off the 16-byte grid
    ((505, 505, 489, 96, 0), 5, True, 8),     # density only
    ((300, 17, 90, 12, 20), 5, True, 1),      # ranks multiples of 4, not of 8
    ((4000, 4000, 4000, 96, 288), 2, True, 1),  # a block of 4 columns
    ((8000, 8000, 8000, 96, 288), 1, True, 1),
    ((130, 140, 150, 47, 5), 5, True, 1),
])
def test_cp_forward_words(dims, log_cw, aligned, want):
    """Columns a lane of the shared route takes: two float4 words where
    the ranks, the block's columns and the pointers allow, else one."""
    assert cpf.forward_words(dims, log_cw, aligned) == want


def _kernel_products(lines, xyz):
    """The forward kernel's arithmetic on the CPU: each axis's corners by
    slot parity, the in-range flag folded into the weights (f * (m * a)
    for (f * m) * a), the two terms added in slot order, the lerps
    multiplied in the axis order 0, 1, 2."""
    prod = None
    for i, line in enumerate(lines):
        g = xyz[:, cpf.VEC_MODE[i]]
        idx, valid, w = corners_1d(line.shape[0], g)
        i0 = torch.floor((g + 1.0) * 0.5 * (line.shape[0] - 1)).to(torch.int32)
        w0 = torch.where(valid[0], 1.0 - w, torch.zeros_like(w))[:, None]
        w1 = torch.where(valid[1], w, torch.zeros_like(w))[:, None]
        t0 = line[idx[0].long()] * w0
        t1 = line[idx[1].long()] * w1
        even = (i0 % 2 == 0)[:, None]
        lerp = torch.where(even, t0 + t1, t1 + t0)
        prod = lerp if prod is None else prod * lerp
    return prod


@pytest.mark.parametrize("name", list(FIELDS))
def test_cp_forward_folded_weights_are_the_plain_lerp_bit_for_bit(name):
    """The shared-memory forward's lerp (two products and a sum a texel,
    the flags in the weights, the terms in slot order) gives the samplers'
    products bit for bit, at corners in range, out of range and at the
    edges."""
    lines, xyz, _, _ = _case(name, seed=9, n=500)
    params = _t(lines)
    x = torch.from_numpy(xyz)
    for kind in cpf.LINES:
        got = _kernel_products(params[kind], x)
        want = cpf.cp_products(params[kind], x)
        assert torch.equal(got, want)


def test_cp_forward_counts_launches_by_route():
    """The forward's launches are counted in all and by route."""
    assert set(cpf.cp_features.launches_by_route) == {"shared", "l1"}


@pytest.mark.parametrize("dims,with_app,run,stages", [
    ((505, 505, 489, 96, 288), True, 8, 2),     # lego's CP ranks: 229 056 B
    ((505, 505, 489, 96, 288), False, 8, 4),    # density only
    ((20, 20, 20, 3, 5), True, 8, 4),
    ((16, 17, 18, 4, 292), True, 8, 2),         # the widest at 8 samples a stage
    ((16, 17, 18, 4, 293), True, 4, 3),
    ((16, 17, 18, 4, 400), True, 4, 2),
    ((16, 17, 18, 4, 588), True, 4, 2),         # the widest taken
    ((60000, 0, 0, 4, 4), True, 8, 4),          # line lengths do not count
])
def test_cp_coords_plan(dims, with_app, run, stages):
    """The coordinate gradient's stage and ring: the longest stage at the
    deepest ring whose blocks fit MAX_SMEM."""
    assert cpf.coords_plan(dims, with_app) == (run, stages)
    ra = dims[4] if with_app else 0
    assert cpf.coords_smem(ra, run, stages) <= cpf.MAX_SMEM
    deeper = [(r, k) for r in cpf.COORDS_RUNS for k in cpf.COORDS_STAGES
              if (r, k) > (run, stages) or (r == run and k > stages)]
    assert all(cpf.coords_smem(ra, r, k) > cpf.MAX_SMEM for r, k in deeper)


def test_cp_coords_plan_refuses_ranks_too_wide_for_shared_memory():
    assert cpf.coords_smem(589, 4, 2) > cpf.MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        cpf.coords_plan((16, 17, 18, 4, 589), True)
    assert cpf.coords_plan((16, 17, 18, 4, 589), False) == (8, 4)


def _cgrad_source():
    src = (Path(cpf.__file__).resolve().parents[1] / "csrc"
           / "cp_features.cu").read_text()
    return src[src.index("namespace cgrad {"):src.index("}  // namespace cgrad")]


def test_cp_coords_plan_counts_what_the_kernel_lays_out():
    """The host's constants and shared-memory count are the kernel's: its
    warps, stage lengths, unit, records and ring depths, and the same sum
    of rings, barriers and records."""
    src = _cgrad_source()

    def const(name):
        expr = re.search(rf"\b{name} = ([0-9* ]+)[;,]", src).group(1)
        return math.prod(int(t) for t in expr.split("*"))
    assert const("kWarps") == cpf.COORDS_WARPS
    assert const("kMaxRun") == max(cpf.COORDS_RUNS)
    assert const("kUnit") == cpf.COORDS_UNIT
    assert const("kRecordBytes") == cpf.COORDS_RECORD
    assert const("kMinStages") == min(cpf.COORDS_STAGES)
    assert const("kMaxStages") == max(cpf.COORDS_STAGES)
    assert ("(stages * (static_cast<long long>(run) * (16 + 4LL * ra) + 8) "
            "+ kMaxRun * kRecordBytes)") in src
    entry = (Path(cpf.__file__).resolve().parents[1] / "csrc"
             / "cp_features.cu").read_text()
    assert "(run != 4 && run != 8)" in entry and set(cpf.COORDS_RUNS) == {4, 8}


def _kernel_coords_grad(params, xyz, dsigma, dapp=None):
    """The coordinate kernel's arithmetic on the CPU: for each axis the
    corners' slots by parity (a flagged-out corner's words zeros), the
    lerp ve + (vo - ve) * wo with wo the odd slot's weight, vo - ve times
    the record's factor, (L - 1) / 2 negated where the odd slot holds the
    lower corner; a sample's density and appearance terms summed."""
    kinds = [(params["density_line"], dsigma[:, None])]
    if dapp is not None:
        kinds.append((params["app_line"], dapp))
    acc = [0.0, 0.0, 0.0]
    scale = [None] * 3
    for lines, u in kinds:
        lerps, diffs = [], []
        for i, line in enumerate(lines):
            length = line.shape[0]
            g = xyz[:, cpf.VEC_MODE[i]]
            p = (g + 1.0) * 0.5 * float(length - 1)
            i0 = torch.floor(p).to(torch.int64)
            w = p - i0.to(torch.float32)
            m0 = ((i0 >= 0) & (i0 <= length - 1))[:, None]
            m1 = ((i0 + 1 >= 0) & (i0 + 1 <= length - 1))[:, None]
            f0 = line[i0.clamp(0, length - 1)] * m0
            f1 = line[(i0 + 1).clamp(0, length - 1)] * m1
            even = (i0 % 2 == 0)[:, None]
            ve, vo = torch.where(even, f0, f1), torch.where(even, f1, f0)
            wo = torch.where(even, w[:, None], 1.0 - w[:, None])
            diffs.append(vo - ve)
            lerps.append(ve + diffs[-1] * wo)
            scale[i] = torch.where(even[:, 0], 0.5, -0.5) * float(length - 1)
        u2 = u * lerps[2]
        terms = (u2 * lerps[1] * diffs[0], u2 * lerps[0] * diffs[1],
                 u * (lerps[0] * lerps[1]) * diffs[2])
        acc = [a + t.sum(-1) for a, t in zip(acc, terms)]
    out = torch.empty_like(xyz)
    for i in range(3):
        out[:, 2 - i] = acc[i] * scale[i]
    return out


@pytest.mark.parametrize("name", list(FIELDS))
@pytest.mark.parametrize("with_app", [False, True])
def test_cp_coords_kernel_arithmetic_matches_the_plain_gradient(name, with_app):
    """The coordinate kernel's records and walk, modelled on the CPU,
    against ``cp_features_coords_grad_plain`` within GRAD_TOL of the
    largest, at corners in range, out of range and at the edges."""
    lines, xyz, dsigma, dapp = _case(name, seed=10, n=500)
    params = _t(lines)
    x, ds = torch.from_numpy(xyz), torch.from_numpy(dsigma)
    da = torch.from_numpy(dapp) if with_app else None
    got = _kernel_coords_grad(params, x, ds, da)
    want = cpf.cp_features_coords_grad_plain(params, x, ds, da)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=GRAD_TOL * float(want.abs().max()))


def test_cp_time_iteration_upstream_runs_along_each_ray():
    """The timing tool's iteration-like upstream: one run of live samples
    a ray, each word of a live sample drawn, about 3.4 % of the samples."""
    params = {"app_line": (torch.zeros((4, 6)),) * 3}
    n = cp_time.RAY_SAMPLES * 120
    dsigma, dapp = cp_time.iteration_upstream(params, n, 43, "cpu")
    live = ((dsigma != 0) | (dapp != 0).any(-1)).reshape(120, -1)
    assert 0.025 < float(live.float().mean()) < 0.045
    for ray in live:
        idx = torch.nonzero(ray)[:, 0]
        assert idx.numel() == 0 or idx[-1] - idx[0] + 1 == idx.numel()
    assert bool((dapp[(dsigma != 0)] != 0).all())


@pytest.mark.parametrize("name", sorted(
    n for n, v in cp_time.VARIANTS.items() if cp_time.is_coords(n)))
def test_cp_time_coords_variants_edit_the_coordinate_kernel(name):
    """Each ``--coords`` variant edits the coordinate gradient (its kernel
    or its entry) and nothing else, or sets only the coordinate plan's
    constants, and times that kernel."""
    src = (Path(cpf.__file__).resolve().parents[1] / "csrc"
           / "cp_features.cu").read_text()
    text = cp_time.variant_source(name, src, None)
    assert cp_time.kernel_of(name) == "coords"
    if text == src:
        spec = cp_time.VARIANTS[name][2]
        assert spec and all(k.startswith("COORDS_") and hasattr(cpf, k) for k in spec)
        return
    first = next(i for i, (a, b) in enumerate(zip(src, text)) if a != b)
    kernel = (src.index("namespace cgrad {"), src.index("}  // namespace cgrad"))
    entry = src.index('extern "C" int iff_cp_features_coords_grad(')
    assert kernel[0] < first < kernel[1] or first > entry
