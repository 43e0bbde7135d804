"""Port parity for the fused field features (``ops/field_features.py``,
``models/field.py::compute_features_fused``) and the routes that take them:
``compute_alpha`` (density-only), ``render_rays`` and the surface normals
(with appearance), on each ``fused_eval`` setting, against the JAX package.
On the CPU the wrapper takes its plain version, the grid samplers; what the
kernel refuses and the Python that lays out its arguments are checked here,
the kernel itself on the card (tests/test_torch_cuda_kernels.py). Fields
are the 20^3 fixture and a non-cubic grid with unequal ranks, made by the
JAX package; inputs come from numpy seeds."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iffnerf_tpu.models import field as jfield
from iffnerf_tpu.models import render as jrender
from iffnerf_tpu.pose import sampling as jsamp
from iffnerf_tpu_torch.models import field as tfield
from iffnerf_tpu_torch.models import render as trender
from iffnerf_tpu_torch.ops import field_features as tff
from iffnerf_tpu_torch.ops import gather as tgather
from iffnerf_tpu_torch.ops import grid_sample as tgs
from iffnerf_tpu_torch.pose import sampling as tsamp

from torch_parity import field, near_mask_points, t, unit

FEATURE_TOL = dict(rtol=1e-5, atol=1e-6)
GRIDS = {"cubic": {},
         "non_cubic": dict(grid_size=(16, 17, 18), density_n_comp=(2, 3, 4),
                           app_n_comp=(3, 4, 5))}
SETTINGS = ("auto", "on", "off")


@pytest.fixture(scope="module", params=sorted(GRIDS))
def vm_fields(request, tmp_path_factory):
    return field(tmp_path_factory.mktemp("fused"), seed=7,
                 **GRIDS[request.param])


@pytest.fixture(scope="module")
def vm(tmp_path_factory):
    return field(tmp_path_factory.mktemp("vm"), seed=3)


def _coords(seed, spread, shape=(2, 157)):
    xyz = np.random.default_rng(seed).uniform(-spread, spread, shape + (3,))
    xyz[0, :4] = [[-1, -1, -1], [1, 1, 1], [1, -1, 0], [0, 0, 0]]
    return xyz.astype(np.float32)


def _with(cfg, setting):
    return dataclasses.replace(cfg, fused_eval=setting)


@pytest.mark.parametrize("spread", [1.0, 1.15])
def test_compute_features_fused_matches_jax(vm_fields, spread):
    """Against JAX's compute_features_fused (footprint-packed rows) and its
    separate functions, inside [-1, 1] and beyond it (zeros padding)."""
    (jcfg, jp, _), (tcfg, tp, _) = vm_fields
    xyz = _coords(11, spread)
    sigma, app = tfield.compute_features_fused(tcfg, tp, t(xyz))
    j_sigma, j_app = jfield.compute_features_fused(_with(jcfg, "on"), jp,
                                                   jnp.asarray(xyz))
    assert sigma.shape == xyz.shape[:-1] and app.shape == xyz.shape[:-1] + (27,)
    for got, want in ((sigma, j_sigma), (app, j_app),
                      (sigma, jfield.compute_densityfeature(jcfg, jp, xyz)),
                      (app, jfield.compute_appfeature(jcfg, jp, xyz))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FEATURE_TOL)
    dens, none = tfield.compute_features_fused(tcfg, tp, t(xyz), with_app=False)
    assert none is None
    np.testing.assert_array_equal(dens.numpy(), sigma.numpy())
    if spread > 1:
        outside = (np.abs(xyz) > 1.0 + 2.0 / 15).any(-1)
        assert outside.any() and (sigma.numpy()[outside] == 0).all()


@pytest.mark.parametrize("setting", SETTINGS)
def test_compute_alpha_on_each_fused_eval_setting(vm, setting):
    (jcfg, jp, jmask), (tcfg, tp, tmask) = vm
    pts = np.concatenate([
        near_mask_points(jmask.volume, jcfg.aabb_np, 300, 5, spread=0.1),
        np.random.default_rng(6).uniform(-1.6, 1.6, (80, 3)).astype(np.float32),
    ])
    for mask_j, mask_t in ((jmask, tmask), (None, None)):
        want = np.asarray(jrender.compute_alpha(_with(jcfg, setting), jp, mask_j,
                                                jnp.asarray(pts), 0.3))
        got = trender.compute_alpha(_with(tcfg, setting), tp, mask_t, t(pts),
                                    0.3).numpy()
        np.testing.assert_allclose(got, want, **FEATURE_TOL)
        np.testing.assert_array_equal(got > 0, want > 0)


@pytest.mark.parametrize("setting", SETTINGS)
def test_render_rays_on_each_fused_eval_setting(vm, setting):
    """Surface-centred point-colour rays near the mask, the colour pass's
    form; JAX on "on" takes its compacted march."""
    (jcfg, jp, jmask), (tcfg, tp, tmask) = vm
    rng = np.random.default_rng(12)
    ori = near_mask_points(jmask.volume, jcfg.aabb_np, 200, 13)
    rays = np.concatenate([ori, unit(rng.standard_normal((200, 3)))], -1)
    want = jrender.render_rays(_with(jcfg, setting), jp, jmask,
                               jnp.asarray(rays), white_bg=True,
                               sample_mode="point_color")
    got = trender.render_rays(_with(tcfg, setting), tp, tmask, t(rays),
                              white_bg=True, sample_mode="point_color")
    for name, g, w in zip(("rgb", "depth", "acc", "alpha"), got, want):
        # exp and cumprod along the ray, in another order: 1e-5
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    assert (got[2].numpy() > 0.05).mean() > 0.5, "the rays must see the field"


@pytest.mark.parametrize("setting", ["on", "off"])
def test_surface_normals_on_each_fused_eval_setting(vm, setting):
    (jcfg, jp, jmask), (tcfg, tp, _) = vm
    pts = near_mask_points(jmask.volume, jcfg.aabb_np, 150, 14)
    want = np.asarray(jsamp.samples_points_normals(jcfg, jp, jnp.asarray(pts)))
    got = tsamp.samples_points_normals(_with(tcfg, setting), tp, t(pts)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_use_fused_eval():
    vm = tfield.FieldConfig()
    cp = tfield.FieldConfig(model_name="TensorCP")
    for dev, auto in (("cpu", False), ("cuda", True), ("meta", False)):
        assert tfield.use_fused_eval(vm, torch.device(dev)) is auto
        assert tfield.use_fused_eval(_with(vm, "on"), dev) is True
        assert tfield.use_fused_eval(_with(vm, "off"), dev) is False
        for setting in SETTINGS:
            assert tfield.use_fused_eval(_with(cp, setting), dev) is False


def test_field_features_refuses_what_the_kernel_does_not_take(vm, tmp_path):
    _, (tcfg, tp, _) = vm
    xyz = torch.zeros((5, 3))
    (_, _, _), (cp_cfg, cp_p, _) = field(tmp_path, "TensorCP")
    with pytest.raises(ValueError, match="TensorVMSplit"):
        tff.field_features(cp_cfg, cp_p, xyz)
    with pytest.raises(ValueError, match="float32"):
        tff.field_features(tcfg, tp, xyz.double())
    with pytest.raises(ValueError, match=r"\[\.\.\., 3\]"):
        tff.field_features(tcfg, tp, torch.zeros((5, 2)))
    half = dict(tp, app_line=(tp["app_line"][0].double(),) + tp["app_line"][1:])
    with pytest.raises(ValueError, match=r"app_line\[0\] must be float32"):
        tff.field_features(tcfg, half, xyz)
    strided = dict(tp, density_plane=(tp["density_plane"][0].transpose(0, 1),)
                   + tp["density_plane"][1:])
    with pytest.raises(ValueError, match="contiguous"):
        tff.field_features(tcfg, strided, xyz)
    meta = {k: tuple(a.to("meta") for a in v) if isinstance(v, tuple) else v
            for k, v in tp.items()}
    with pytest.raises(ValueError, match="is on meta"):
        tff.field_features(tcfg, meta, xyz)
    with pytest.raises(ValueError, match="no field-feature kernel"):
        tff.field_features(tcfg, meta, xyz.to("meta"))


def test_kernel_layout_of_a_non_cubic_field():
    """Plane i is [g[m1], g[m0], R] (x -> W), line i [g[vec], R]; the app
    products of pair i start where pair i - 1's end."""
    grid, rd, ra = (16, 17, 18), (2, 3, 4), (3, 4, 5)
    params = {}
    for kind, ranks in (("density", rd), ("app", ra)):
        params[f"{kind}_plane"] = tuple(
            torch.zeros((grid[m1], grid[m0], ranks[i]))
            for i, (m0, m1) in enumerate(tff.MAT_MODE))
        params[f"{kind}_line"] = tuple(torch.zeros((grid[v], ranks[i]))
                                       for i, v in enumerate(tff.VEC_MODE))
    tables, dims = tff.kernel_layout(params, with_app=True)
    assert dims == [17, 16, 18, 2, 3,
                    18, 16, 17, 3, 4,
                    18, 17, 16, 4, 5,
                    0, 3, 7, 12]
    order = [params[f"{k}_{p}"][i] for k in ("density", "app")
             for p in ("plane", "line") for i in range(3)]
    assert all(a is b for a, b in zip(tables, order)) and len(tables) == 12
    tables, dims = tff.kernel_layout(params, with_app=False)
    assert tables[6:] == [None] * 6
    assert dims == [17, 16, 18, 2, 0, 18, 16, 17, 3, 0, 18, 17, 16, 4, 0,
                    0, 0, 0, 0]
    bad = dict(params, app_line=params["app_line"][:2]
               + (torch.zeros((15, 5)),))
    with pytest.raises(ValueError, match="app plane 2 or line 2"):
        tff.kernel_layout(bad, with_app=True)


def test_each_grid_sampler_fetches_its_corners_at_once(monkeypatch):
    """One row gather a sampler call: 2, 4 or 8 stacked corners a point."""
    calls = []

    def counted(table, idx):
        calls.append(idx.shape[0])
        return tgather.gather_rows_plain(table, idx)

    monkeypatch.setattr(tgs, "gather_rows", counted)
    rng = np.random.default_rng(15)
    xyz = t(rng.uniform(-1.1, 1.1, (3, 41, 3)).astype(np.float32))
    tgs.grid_sample_1d(torch.ones((9, 4)), xyz[..., 0])
    tgs.grid_sample_2d(torch.ones((9, 10, 4)), xyz[..., :2])
    tgs.grid_sample_3d(torch.ones((9, 10, 11)), xyz)
    assert calls == [2 * 123, 4 * 123, 8 * 123]


def test_gather_route_choice():
    """The bucketed route only for wide rows of a table beyond L2 that the
    indices read more than once; at most 64 buckets."""
    rpb = tgather.rows_per_bucket
    assert rpb(90000, 256, 1 << 21) == tgather.BUCKET_BYTES // 1024
    assert rpb(300 ** 3, 1, 8 * 204660) == 0          # the mask: 4-byte rows
    assert rpb(90000, 48, 204660) == 0                # 17 MB fits L2
    assert rpb(90000, 256, 50000) == 0                # fewer reads than rows
    many = rpb(10 ** 7, 64, 10 ** 8)
    assert -(-10 ** 7 // many) <= tgather.MAX_BUCKETS
