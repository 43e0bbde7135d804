"""Port parity for the field's training math (``iffnerf_tpu_torch``'s
``models/field.py``, ``models/render.py``, ``models/shading.py``,
``ops/interpolate.py``, ``utils/``) against the JAX package, and the F4 and
F5 repairs of the pose harness's and the renderer's signatures.

Fields are made by the JAX package (``torch_parity.field``: a 20^3 grid,
Ref shading) and reach the port through its checkpoint bridge; inputs and
upstream gradients come from numpy seeds, and draws that the two packages
make differently (initialisation, jitter) are compared by their statistics
or handed from JAX to the port. Every tolerance is stated beside its test.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iffnerf_tpu.models import field as jfield
from iffnerf_tpu.models import render as jrender
from iffnerf_tpu.ops import interpolate as jinterp
from iffnerf_tpu.pose import id_module as jid
from iffnerf_tpu.pose import solve as jsolve
from iffnerf_tpu.pose import test as jtest
from iffnerf_tpu.render import renderer as jrenderer
from iffnerf_tpu.utils import metrics as jmetrics
from iffnerf_tpu.utils import misc as jmisc
from iffnerf_tpu_torch.checkpoint import _flatten, _numpy_leaves, params_from_numpy
from iffnerf_tpu_torch.models import field as tfield
from iffnerf_tpu_torch.models import render as trender
from iffnerf_tpu_torch.ops import field_features as tff
from iffnerf_tpu_torch.ops import interpolate as tinterp
from iffnerf_tpu_torch.pose import id_module as tid
from iffnerf_tpu_torch.pose import solve as tsolve
from iffnerf_tpu_torch.pose import test as ttest
from iffnerf_tpu_torch.render import renderer as trenderer
from iffnerf_tpu_torch.utils import metrics as tmetrics
from iffnerf_tpu_torch.utils import misc as tmisc

from torch_parity import field, near_mask_points, t, unit

TABLES = tff.TABLES


@pytest.fixture(scope="module", params=["TensorVMSplit", "TensorCP"])
def fields(request, tmp_path_factory):
    return field(tmp_path_factory.mktemp("train_field"), request.param)


@pytest.fixture(scope="module")
def vm(tmp_path_factory):
    return field(tmp_path_factory.mktemp("train_vm"), seed=4,
                 grid_size=(20, 22, 24), density_n_comp=(4, 3, 5),
                 app_n_comp=(8, 6, 7))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return {k: np.asarray(v, np.float32)
            for k, v in _flatten(_numpy_leaves(tree)).items()}


def _leaf_close(got, want, share, what):
    """Each leaf within ``share`` of its own largest |value|."""
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys(), what
    for name, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[name] - w).max())
        assert err <= share * scale, f"{what} {name}: {err} > {share} x {scale}"


# ---------------------------------------------------------------------------
# F4: the pose harness takes JAX's parameters in JAX's order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jax_fn,port_fn,trailing", [
    (jtest.test_pose_estimation, ttest.test_pose_estimation, ("device",)),
    (jid.score_rays, tid.score_rays, ()),
    (jrenderer.render_chunked, trenderer.render_chunked, ("device",)),
    (jrenderer.evaluation, trenderer.evaluation, ("device", "log")),
    (jrenderer.evaluation_path, trenderer.evaluation_path, ("device", "log")),
    (jsolve.estimate_pose_single_sharded, tsolve.estimate_pose_single_sharded,
     ("device",)),
])
def test_signatures_follow_jax_order(jax_fn, port_fn, trailing):
    """The port's parameter names, in order, are JAX's plus a trailing
    ``device`` (and the renderers' ``log``), with JAX's defaults (a call
    in JAX's positional order binds the same ones)."""
    want = list(inspect.signature(jax_fn).parameters) + list(trailing)
    assert list(inspect.signature(port_fn).parameters) == want
    for name, p in inspect.signature(jax_fn).parameters.items():
        assert inspect.signature(port_fn).parameters[name].default == p.default


@pytest.fixture(scope="module")
def f5_field(tmp_path_factory):
    return field(tmp_path_factory.mktemp("f5"), seed=0)


@pytest.mark.parametrize("args", [(256, -1, True), (7, 12, False, False,
                                                    None, False)])
def test_render_chunked_positional_matches_jax(f5_field, args):
    """F5: ``render_chunked`` called positionally in JAX's order (the
    fault's call: chunk 256, n_samples -1, white_bg; and chunks of 7 rays
    at 12 samples with every parameter through ``active_rays``) on the
    20^3 field of seed 0 and 64 rays from numpy seed 0 (origins within
    0.3 of (0, 0, -3), directions (0, 0, 1) + N(0, 0.1)): rgb and depth
    within the render parity rule, rtol 1e-5 and atol 1e-6."""
    (jcfg, jp, jmask), (tcfg, tp, tmask) = f5_field
    rng = np.random.default_rng(0)
    ori = rng.uniform(-0.3, 0.3, (64, 3)) + np.array([0.0, 0.0, -3.0])
    dirs = unit(np.array([0.0, 0.0, 1.0]) + rng.normal(0, 0.1, (64, 3)))
    rays = np.concatenate([ori, dirs], -1).astype(np.float32)
    want = jrenderer.render_chunked(jcfg, jp, jmask, rays, *args)
    got = trenderer.render_chunked(tcfg, tp, tmask, rays, *args,
                                   device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# field_features' gradient on the CPU against jax.grad
# ---------------------------------------------------------------------------


def _feature_problem(jp, n, seed):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.1, 1.1, (n, 3)).astype(np.float32)
    xyz[:2] = [[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]]
    ws = rng.standard_normal(n).astype(np.float32)
    wa = rng.standard_normal((n, jp["basis_mat"]["w"].shape[1])).astype(
        np.float32)
    return xyz, ws, wa


@pytest.mark.parametrize("with_app", [True, False])
def test_field_features_gradients_match_jax(vm, with_app):
    """sum(sigma * ws) (+ sum(app * wa)) differentiated in the tables and
    basis_mat: the port's field_features under torch autograd against
    jax.grad of compute_densityfeature and compute_appfeature. 600 samples
    a few texels apart: float32 sums of up to tens of terms a texel in
    another order, 1e-5 of each leaf's largest |grad|."""
    (jcfg, jp, _), (tcfg, tp, _) = vm
    xyz, ws, wa = _feature_problem(jp, 600, 3)
    names = list(TABLES if with_app else TABLES[:2])
    if with_app:
        names.append("basis_mat")

    def jloss(sub):
        q = dict(jp, **sub)
        total = jnp.sum(jfield.compute_densityfeature(jcfg, q, xyz) * ws)
        if with_app:
            total = total + jnp.sum(
                jfield.compute_appfeature(jcfg, q, xyz) * wa)
        return total

    want = jax.grad(jloss)({k: jp[k] for k in names})
    leaves = {k: jax.tree_util.tree_map(
        lambda a: a.clone().requires_grad_(), tp[k]) for k in names}
    q = dict(tp, **leaves)
    sigma, prods = tff.field_features(tcfg, q, t(xyz), with_app)
    total = torch.sum(sigma * t(ws))
    if with_app:
        app = prods @ q["basis_mat"]["w"]
        total = total + torch.sum(app * t(wa))
    total.backward()
    got = jax.tree_util.tree_map(lambda a: a.grad, leaves)
    _leaf_close(got, _numpy_tree(want), 1e-5, "field_features grad")


def test_field_features_backward_plain_is_autograd(vm):
    """The backward's plain version (what the card's kernel is held to)
    against autograd through field_features on the CPU: the same
    function, 1e-6 of each leaf's largest."""
    _, (tcfg, tp, _) = vm
    xyz, ws, _ = _feature_problem({"basis_mat": {"w": np.zeros((1, 2))}},
                                  300, 5)
    width = sum(tcfg.app_n_comp)
    dapp = torch.randn((300, width), generator=torch.Generator().manual_seed(1))
    got = tff.field_features_backward(tcfg, tp, t(xyz), t(ws), dapp)
    leaves = {k: tuple(a.clone().requires_grad_() for a in tp[k])
              for k in TABLES}
    sigma, prods = tff.field_features(tcfg, leaves, t(xyz), True)
    (torch.sum(sigma * t(ws)) + torch.sum(prods * dapp)).backward()
    want = {k: tuple(a.grad for a in leaves[k]) for k in TABLES}
    _leaf_close(got, want, 1e-6, "field_features_backward")
    dens = tff.field_features_backward(tcfg, tp, t(xyz), t(ws))
    assert sorted(dens) == sorted(TABLES[:2])
    _leaf_close(dens, {k: want[k] for k in TABLES[:2]}, 1e-6, "density only")


def _emulated_launches(monkeypatch):
    """The kernels' launches emulated on the CPU, so that the
    autograd.Function around them runs here: the forward is the plain
    version; the backward repeats the kernel's arithmetic (each corner's
    weight times the other factor times the upstream gradient, added into
    the zeroed gradient of each wanted table, nothing for a flagged-out
    corner or a zero upstream word) with index_add in place of atomics,
    launched only when a gradient is wanted."""
    from iffnerf_tpu_torch.ops.grid_sample import corners_1d, corners_2d

    def forward(tables, dims, flat, with_app):
        p = {k: tuple(tables[3 * j:3 * j + 3]) for j, k in enumerate(TABLES)}
        return tff.field_features_plain(p, flat, with_app)

    def backward(tables, dims, flat, dsigma, dapp, wanted):
        grads = [torch.zeros_like(a) if a is not None and w else None
                 for a, w in zip(tables, wanted)]
        for i, (m0, m1) in enumerate(tff.MAT_MODE):
            h, w, length, rd, ra = dims[5 * i:5 * i + 5]
            idx2, v2, (wx, wy) = corners_2d(h, w, flat[:, [m0, m1]])
            idx1, v1, wl = corners_1d(length, flat[:, tff.VEC_MODE[i]])
            wc = torch.stack([(1 - wy) * (1 - wx), (1 - wy) * wx,
                              wy * (1 - wx), wy * wx]) * v2
            wlc = torch.stack([1 - wl, wl]) * v1
            ups = [(0, dsigma[:, None].expand(-1, rd))]
            if dapp is not None:
                ups.append((6, dapp[:, dims[15 + i]:dims[15 + i] + ra]))
            for base, up in ups:
                plane, line = tables[base + i], tables[base + 3 + i]
                pf = (plane.reshape(h * w, -1)[idx2.long()]
                      * wc[..., None]).sum(0)
                lf = (line[idx1.long()] * wlc[..., None]).sum(0)
                if grads[base + i] is not None:
                    flat_g = grads[base + i].view(h * w, -1)
                    for k in range(4):
                        flat_g.index_add_(0, idx2[k].long(),
                                          wc[k, :, None] * lf * up)
                if grads[base + 3 + i] is not None:
                    for k in range(2):
                        grads[base + 3 + i].index_add_(
                            0, idx1[k].long(), wlc[k, :, None] * pf * up)
        if any(g is not None for g in grads):  # the wrapper's launch rule
            tff.field_features_backward.launches += 1
        return grads

    monkeypatch.setattr(tff, "_launch_forward", forward)
    monkeypatch.setattr(tff, "_launch_backward", backward)


@pytest.mark.parametrize("with_app", [True, False])
def test_field_features_function_routes_gradients(vm, with_app, monkeypatch):
    """The autograd.Function of the CUDA route, on the CPU with emulated
    launches: a loss through it gives every table that requires grad the
    gradient of autograd through the plain version (1e-6 of each leaf's
    largest), a table that does not gets none, and the backward launches
    once."""
    _emulated_launches(monkeypatch)
    _, (tcfg, tp, _) = vm
    xyz, ws, _ = _feature_problem({"basis_mat": {"w": np.zeros((1, 2))}},
                                  400, 8)
    names = TABLES if with_app else TABLES[:2]
    leaves = {k: tuple(a.clone().requires_grad_(i != 1)
                       for i, a in enumerate(tp[k])) for k in names}
    tables, dims = tff.kernel_layout(leaves, with_app)
    before = tff.field_features_backward.launches
    out = tff._FieldFeatures.apply(dims, with_app, t(xyz), *tables)
    sigma, prods = out if with_app else (out, None)
    loss = torch.sum(sigma * t(ws))
    if with_app:
        loss = loss + torch.sum(torch.sin(prods))
    loss.backward()
    assert tff.field_features_backward.launches == before + 1
    plain = {k: tuple(a.detach().clone().requires_grad_() for a in tp[k])
             for k in names}
    s2, p2 = tff.field_features_plain(plain, t(xyz), with_app)
    loss2 = torch.sum(s2 * t(ws))
    if with_app:
        loss2 = loss2 + torch.sum(torch.sin(p2))
    loss2.backward()
    for k in names:
        assert leaves[k][1].grad is None
        _leaf_close({k: (leaves[k][0].grad, leaves[k][2].grad)},
                    {k: (plain[k][0].grad, plain[k][2].grad)}, 1e-6, k)


@pytest.fixture(scope="module")
def vm32(tmp_path_factory):
    """A 32^3-class non-cubic VM field with unequal ranks."""
    return field(tmp_path_factory.mktemp("coords_vm"), seed=6,
                 grid_size=(30, 32, 34), density_n_comp=(4, 3, 5),
                 app_n_comp=(8, 6, 7))


def _coordinate_problem(jcfg, jp):
    """Points inside and beyond [-1, 1], on texel boundaries (every
    coordinate at a texel of its axis) and on axis-aligned lines through
    texel boundaries; upstream weights for sigma and the app feature."""
    rng = np.random.default_rng(11)
    sizes = np.asarray(jcfg.grid_size)
    inside = rng.uniform(-0.95, 0.95, (300, 3))
    beyond = rng.uniform(-1.3, 1.3, (300, 3))
    texel = rng.integers(0, sizes, (200, 3)) * 2.0 / (sizes - 1) - 1.0
    axis = np.repeat(texel[:3], 40, axis=0)
    for k in range(3):
        axis[40 * k:40 * (k + 1), k] = np.linspace(-1.2, 1.2, 40)
    xyz = np.concatenate([inside, beyond, texel, axis]).astype(np.float32)
    ws = rng.standard_normal(len(xyz)).astype(np.float32)
    wa = rng.standard_normal((len(xyz), jcfg.app_dim)).astype(np.float32)
    return xyz, ws, wa


@pytest.mark.parametrize("jax_route", ["compute_features_fused",
                                       "grid_samplers"])
def test_field_features_coordinate_gradient_matches_jax(vm32, jax_route):
    """sum(sigma * ws) + sum(app * wa) differentiated in the coordinates,
    the tables frozen: the port's compute_features_fused under torch
    autograd, and field_features_coords_grad_plain (the coordinate
    kernel's plain version) fed the upstream through basis_mat, against
    jax.grad of the JAX package's compute_features_fused (its packed
    jnp.take route on the CPU) or of compute_densityfeature +
    compute_appfeature (the grid samplers). w = p - floor(p) carries the
    gradient, a flagged-out corner gives none, and d p / d g = (size - 1) /
    2. Float32 sums of up to 3 x (5 + 8) terms a coordinate in another
    order: 1e-5 of the largest |grad|."""
    (jcfg, jp, _), (tcfg, tp, _) = vm32
    xyz, ws, wa = _coordinate_problem(jcfg, jp)

    def jloss(c):
        if jax_route == "compute_features_fused":
            sigma, app = jfield.compute_features_fused(jcfg, jp, c)
        else:
            sigma = jfield.compute_densityfeature(jcfg, jp, c)
            app = jfield.compute_appfeature(jcfg, jp, c)
        return jnp.sum(sigma * ws) + jnp.sum(app * wa)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(xyz)))
    scale = float(np.abs(want).max())
    leaf = t(xyz).requires_grad_()
    sigma, app = tfield.compute_features_fused(tcfg, tp, leaf)
    (torch.sum(sigma * t(ws)) + torch.sum(app * t(wa))).backward()
    np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=0,
                               atol=1e-5 * scale)
    plain = tff.field_features_coords_grad_plain(
        tp, t(xyz), t(ws), t(wa) @ tp["basis_mat"]["w"].T)
    np.testing.assert_allclose(plain.numpy(), want, rtol=0, atol=1e-5 * scale)
    assert np.abs(want[600:800]).max() > 0.1 * scale  # texel points move it


@pytest.mark.parametrize("tables_grad", [False, True])
def test_field_features_function_routes_the_coordinate_gradient(
        vm, tables_grad, monkeypatch):
    """The autograd.Function of the CUDA route, on the CPU with emulated
    launches (the coordinate launch is field_features_coords_grad_plain):
    an xyz that requires grad gets the gradient of autograd through the
    plain version from one coordinate launch; with tables that require
    grad too, the table backward launches as well, once."""
    _emulated_launches(monkeypatch)

    def coords(tables, dims, flat, dsigma, dapp):
        p = {k: tuple(tables[3 * j:3 * j + 3]) for j, k in enumerate(TABLES)}
        tff.field_features_coords_grad.launches += 1
        return tff.field_features_coords_grad_plain(p, flat, dsigma, dapp)

    monkeypatch.setattr(tff, "_launch_coords_grad", coords)
    _, (tcfg, tp, _) = vm
    xyz, ws, _ = _feature_problem({"basis_mat": {"w": np.zeros((1, 2))}},
                                  300, 9)
    leaves = {k: tuple(a.clone().requires_grad_(tables_grad) for a in tp[k])
              for k in TABLES}
    tables, dims = tff.kernel_layout(leaves, True)
    before = (tff.field_features_backward.launches,
              tff.field_features_coords_grad.launches)
    leaf = t(xyz).requires_grad_()
    sigma, prods = tff._FieldFeatures.apply(dims, True, leaf, *tables)
    (torch.sum(sigma * t(ws)) + torch.sum(torch.sin(prods))).backward()
    assert (tff.field_features_backward.launches,
            tff.field_features_coords_grad.launches) == (
                before[0] + tables_grad, before[1] + 1)
    plain = t(xyz).requires_grad_()
    s2, p2 = tff.field_features_plain(tp, plain, True)
    (torch.sum(s2 * t(ws)) + torch.sum(torch.sin(p2))).backward()
    _leaf_close({"xyz": leaf.grad}, {"xyz": plain.grad}, 1e-6, "xyz")
    assert all((a.grad is not None) == tables_grad
               for k in TABLES for a in leaves[k])


# ---------------------------------------------------------------------------
# initialisation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model_name,shading", [
    ("TensorVMSplit", "Ref"), ("TensorVMSplit", "MLP_Fea"),
    ("TensorCP", "MLP_PE"), ("TensorVMSplit", "SH")])
def test_init_field_shapes_and_scales(model_name, shading):
    """The same tree and shapes as JAX's init_field; each factor's standard
    deviation, in both packages, at its scale (0.1 VM, 0.2 CP) within five
    times its sampling error, 5 / sqrt(2 n) relative for n draws; every
    Linear weight inside the same +-1/sqrt(fan_in) bound, basis_mat
    without bias, MLP heads' last bias zero."""
    scale = 0.1 if model_name == "TensorVMSplit" else 0.2
    cfg = dict(model_name=model_name, grid_size=(20, 24, 28),
               density_n_comp=(4, 4, 4) if model_name == "TensorVMSplit"
               else (8, 8, 8), app_n_comp=(8, 8, 8), shading_mode=shading,
               view_pe=2, fea_pe=2, pos_pe=2, feature_c=32)
    jp = _flat(jfield.init_field(jax.random.PRNGKey(0),
                                 jfield.FieldConfig(**cfg)))
    tp = _flat(tfield.init_field(torch.Generator().manual_seed(0),
                                 tfield.FieldConfig(**cfg)))
    assert tp.keys() == jp.keys()
    assert "basis_mat/b" not in tp
    for name, want in jp.items():
        got = tp[name]
        assert got.shape == want.shape and got.dtype == np.float32, name
        if name.endswith("/w") or name.endswith("/b"):
            fan_in = jp[name[:-1] + "w"].shape[0]
            assert np.abs(got).max() <= 1 / np.sqrt(fan_in) + 1e-7, name
            if not np.any(want):
                assert not np.any(got), name
        else:
            rtol = 5 / np.sqrt(2 * got.size)
            for a in (got, want):
                np.testing.assert_allclose(a.std(), scale, rtol=rtol,
                                           err_msg=name)
                assert abs(a.mean()) < 5 * scale / np.sqrt(a.size), name


# ---------------------------------------------------------------------------
# regularisers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tv_loss_density", "tv_loss_app",
                                  "density_l1", "vector_comp_diffs"])
def test_regularisers_value_and_gradient(fields, name):
    """Value within rtol 1e-6 and each leaf's gradient within 1e-6 of its
    largest: sums over a few thousand float32 terms in another order."""
    (jcfg, jp, _), (tcfg, tp, _) = fields
    names = [k for k in TABLES if k in jp]
    want_v, want_g = jax.value_and_grad(
        lambda sub: getattr(jfield, name)(jcfg, dict(jp, **sub)))(
        {k: jp[k] for k in names})
    leaves = {k: tuple(a.clone().requires_grad_() for a in tp[k])
              for k in names}
    got_v = getattr(tfield, name)(tcfg, dict(tp, **leaves))
    got_v.backward()
    np.testing.assert_allclose(float(got_v.detach()), float(want_v), rtol=1e-6)
    got_g = {k: tuple(torch.zeros_like(a) if a.grad is None else a.grad
                      for a in leaves[k]) for k in names}
    _leaf_close(got_g, _numpy_tree(want_g), 1e-6, name)


# ---------------------------------------------------------------------------
# phase events
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [(7, 13), (13, 7), (1, 5), (20, 20),
                                     (40, 57)])
def test_resize_matches_jax(src, dst):
    """The interpolation matrix is numpy in both; the products float32:
    1e-6."""
    x = np.random.default_rng(src).standard_normal((src, 3, 5)).astype(
        np.float32)
    np.testing.assert_array_equal(tinterp._interp_matrix(src, dst),
                                  jinterp._interp_matrix(src, dst))
    for axis in (0, 1):
        want = np.asarray(jinterp.resize_linear_ac(jnp.asarray(x), dst, axis))
        got = tinterp.resize_linear_ac(t(x), dst, axis).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(
        tinterp.resize_bilinear_ac(t(x), dst, dst + 2).numpy(),
        np.asarray(jinterp.resize_bilinear_ac(jnp.asarray(x), dst, dst + 2)),
        atol=1e-6)


def test_upsample_volume_grid_matches_jax(fields):
    """A 20^3 grid to (27, 31, 25): the config equal, every factor within
    1e-6 (products of the same numpy matrices)."""
    (jcfg, jp, _), (tcfg, tp, _) = fields
    jc2, jp2 = jfield.upsample_volume_grid(jcfg, jp, (27, 31, 25))
    tc2, tp2 = tfield.upsample_volume_grid(tcfg, tp, (27, 31, 25))
    assert tc2.grid_size == jc2.grid_size == (27, 31, 25)
    _leaf_close(tp2, _numpy_tree(jp2), 1e-6, "upsample")
    for k in TABLES:
        for a in tp2.get(k, ()):
            assert a.is_contiguous()


@pytest.mark.parametrize("mask_grid", ["same", "other"])
def test_shrink_matches_jax(fields, mask_grid):
    """Host index arithmetic in both: the config (AABB, grid) equal and the
    cropped factors bit-equal, with the AABB snapped to the grid when the
    mask's grid is another."""
    (jcfg, jp, _), (tcfg, tp, _) = fields
    new_aabb = np.asarray([[-0.9, -1.1, -0.7], [0.8, 1.2, 0.95]], np.float32)
    grid = (jcfg.grid_size if mask_grid == "same" else (16, 18, 20))
    jc2, jp2 = jfield.shrink(jcfg, jp, new_aabb, grid)
    tc2, tp2 = tfield.shrink(tcfg, tp, new_aabb, grid)
    assert tc2.grid_size == jc2.grid_size and tc2.aabb == jc2.aabb
    _leaf_close(tp2, _numpy_tree(jp2), 0.0, "shrink")


@pytest.mark.parametrize("with_mask", [False, True])
def test_update_alpha_mask_matches_jax(vm, with_mask):
    """The 3^3 max-pooled, thresholded occupancy volume equal, the new AABB
    within 1e-6 and the occupied fraction equal, at the mask's default
    grid cut to 40^3, with and without a previous mask. The lattice is
    JAX's (float32 linspace as its CPU backend rounds it). The density
    planes are scaled by 30 in both, so that alpha spreads over 0.04-0.23
    and the threshold 0.2 cuts it."""
    (jcfg, jp, jmask), (tcfg, _, tmask) = vm
    jp = dict(jp, density_plane=tuple(30 * a for a in jp["density_plane"]))
    tp = params_from_numpy(_numpy_tree(jp), device="cpu")
    jcfg = jcfg.replace(alpha_mask_thres=0.2)
    tcfg = tcfg.replace(alpha_mask_thres=0.2)
    grid = (40, 36, 32)
    jm, jaabb, jocc = jfield.update_alpha_mask(
        jcfg, jp, jmask if with_mask else None, grid)
    tm, taabb, tocc = tfield.update_alpha_mask(
        tcfg, tp, tmask if with_mask else None, grid)
    assert tm.volume.shape == (32, 36, 40)
    np.testing.assert_array_equal(tm.volume.numpy(), np.asarray(jm.volume))
    np.testing.assert_allclose(taabb, jaabb, atol=1e-6)
    assert tocc == pytest.approx(jocc, abs=0.0)
    assert 0.05 < tocc < 0.95, "the threshold must cut the field"
    np.testing.assert_array_equal(tm.aabb.numpy(), np.asarray(jm.aabb))


def test_get_dense_alpha_chunks_agree(vm, monkeypatch):
    """The lattice in chunks of 7 points gives the one-chunk values to
    float32 rounding (the CPU's vector kernels round a short tail in
    another order): 1e-6."""
    _, (tcfg, tp, tmask) = vm
    whole, xyz = tfield.get_dense_alpha(tcfg, tp, tmask, (9, 8, 7))
    monkeypatch.setattr(tfield, "DENSE_ALPHA_CHUNK", 7)
    parts, _ = tfield.get_dense_alpha(tcfg, tp, tmask, (9, 8, 7))
    assert whole.shape == (9, 8, 7) and xyz.shape == (9, 8, 7, 3)
    torch.testing.assert_close(parts, whole, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# training sampling
# ---------------------------------------------------------------------------


def test_sample_ray_with_jax_jitter(vm):
    """JAX's own draw handed to the port: xyz, z_vals and validity within
    1e-6 (the same float32 arithmetic), and the port's generator draws one
    uniform a ray in [0, 1)."""
    (jcfg, _, jmask), (tcfg, _, _) = vm
    rng = np.random.default_rng(12)
    target = near_mask_points(jmask.volume, jcfg.aabb_np, 200, 13)
    ori = unit(rng.standard_normal((200, 3))) * 4.0
    dirs = unit(target - ori)
    key = jax.random.PRNGKey(7)
    want = jrender.sample_ray(jcfg, jnp.asarray(ori), jnp.asarray(dirs),
                              key=key, is_train=True)
    jitter = jax.random.uniform(key, (200, 1), jnp.float32)
    got = trender.sample_ray(tcfg, t(ori), t(dirs), jitter=t(jitter))
    for name, g, w in zip(("xyz", "z_vals", "valid"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   err_msg=name)
    # a generator's draw differs from the JAX key's, but is a jitter a ray
    gen = torch.Generator().manual_seed(0)
    _, z, _ = trender.sample_ray(tcfg, t(ori), t(dirs), gen=gen)
    _, z0, _ = trender.sample_ray(tcfg, t(ori), t(dirs), is_train=False)
    frac = ((z - z0) / tcfg.step_size).numpy()
    assert np.ptp(frac, axis=1).max() < 1e-4
    assert 0.0 <= frac.min() and frac.max() < 1.0 and frac.std() > 0.2
    with pytest.raises(ValueError, match="generator"):
        trender.sample_ray(tcfg, t(ori), t(dirs))


def test_render_rays_under_grad_matches_jax(vm):
    """render_rays with training jitter, differentiated through rgb and
    alpha against jax.grad of the same sum: each leaf within 1e-5 of its
    largest (dense float32 marches in another order)."""
    (jcfg, jp, jmask), (tcfg, tp, tmask) = vm
    rng = np.random.default_rng(14)
    target = near_mask_points(jmask.volume, jcfg.aabb_np, 150, 15)
    ori = unit(rng.standard_normal((150, 3))) * 4.0
    rays = np.concatenate([ori, unit(target - ori)], -1).astype(np.float32)
    key = jax.random.PRNGKey(3)
    w = rng.standard_normal((150, 3)).astype(np.float32)

    def jloss(p):
        rgb, _, _, alpha, _, _ = jrender.render_rays(
            jcfg, p, jmask, jnp.asarray(rays), key=key, is_train=True,
            white_bg=True)
        return jnp.sum(rgb * w) + jnp.mean(alpha)

    want = jax.grad(jloss)(jp)
    leaves = jax.tree_util.tree_map(lambda a: a.clone().requires_grad_(), tp)
    rgb, depth, _, alpha, _, _ = trender.render_rays(
        tcfg, leaves, tmask, t(rays), is_train=True, white_bg=True,
        jitter=t(jax.random.uniform(key, (150, 1), jnp.float32)))
    assert not depth.requires_grad
    (torch.sum(rgb * t(w)) + torch.mean(alpha)).backward()
    got = jax.tree_util.tree_map(
        lambda a: torch.zeros_like(a) if a.grad is None else a.grad, leaves)
    _leaf_close(got, _numpy_tree(want), 1e-5, "render_rays grad")


# ---------------------------------------------------------------------------
# host helpers and metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [24 ** 3, 128 ** 3, 300 ** 3, 2097156])
def test_grid_helpers_match(n):
    bbox = [[-1.5, -1.2, -0.9], [1.5, 1.3, 1.1]]
    assert tmisc.N_to_reso(n, bbox) == jmisc.N_to_reso(n, bbox)
    reso = tmisc.N_to_reso(n, bbox)
    assert tmisc.cal_n_samples(reso, 0.5) == jmisc.cal_n_samples(reso, 0.5)
    assert (tmisc.n_voxel_schedule(n, 27000000, 5)
            == jmisc.n_voxel_schedule(n, 27000000, 5))


def test_psnr_and_ssim_match():
    """mse2psnr exact; SSIM within 1e-5 (a separable valid blur in numpy
    against jax.scipy's convolve2d, float32)."""
    rng = np.random.default_rng(9)
    a = rng.random((40, 37, 3), dtype=np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    assert tmetrics.mse2psnr(0.0123) == jmetrics.mse2psnr(0.0123)
    want = jmetrics.rgb_ssim(a, b, 1.0)
    assert tmetrics.rgb_ssim(a, b, 1.0) == pytest.approx(want, abs=1e-5)
    np.testing.assert_allclose(tmetrics.rgb_ssim(a, b, return_map=True),
                               jmetrics.rgb_ssim(a, b, return_map=True),
                               atol=1e-5)
    assert tmetrics.rgb_ssim(a, a) == pytest.approx(1.0, abs=1e-6)
    with pytest.raises(RuntimeError, match="lpips"):
        tmetrics.rgb_lpips(a, b)
