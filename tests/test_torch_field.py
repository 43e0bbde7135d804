"""Port parity for field inference: the row gather's plain version against
``jnp.take``, the grid samplers, the field features, the alpha mask,
``compute_alpha``, the shading heads, ``render_rays`` and the field
checkpoints (the JAX format and the reference ``.th``). The field is made
by the JAX package and reaches the port through its ``save_field`` and the
port's ``load_field``; inputs come from numpy seeds."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from iffnerf_tpu import checkpoint as jckpt
from iffnerf_tpu.models import field as jfield
from iffnerf_tpu.models import render as jrender
from iffnerf_tpu.models import shading as jshading
from iffnerf_tpu.ops import grid_sample as jgs
from iffnerf_tpu_torch import checkpoint as tckpt
from iffnerf_tpu_torch.models import field as tfield
from iffnerf_tpu_torch.models import render as trender
from iffnerf_tpu_torch.models import shading as tshading
from iffnerf_tpu_torch.ops import grid_sample as tgs
from iffnerf_tpu_torch.ops.gather import gather_rows, gather_rows_plain

from torch_parity import f32, field, near_mask_points, t, unit

FEATURE_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", params=["TensorVMSplit", "TensorCP"])
def fields(request, tmp_path_factory):
    return field(tmp_path_factory.mktemp("field"), request.param)


@pytest.fixture(scope="module")
def vm(tmp_path_factory):
    return field(tmp_path_factory.mktemp("vm"), seed=3)


# ---------------------------------------------------------------------------
# K3's plain version and the samplers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c", [1, 16, 48, 256])
@pytest.mark.parametrize("n", [0, 1, 1021])
def test_gather_rows_plain_matches_take(c, n):
    """Exact, with the edge indices: R - 1, R and -R - 1 (NaN rows), -1 and
    -R (wrapped, as jnp.take's default mode does)."""
    r = 300
    rng = np.random.default_rng(c * 7 + n)
    table = rng.standard_normal((r, c)).astype(np.float32)
    idx = rng.integers(0, r, n).astype(np.int32)
    idx[:5] = [r - 1, r, -1, -r, -r - 1][:n]
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0))
    got = gather_rows(t(table), t(idx))
    assert got.shape == (n, c) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(gather_rows_plain(t(table), t(idx)).numpy(),
                                  want)
    if n >= 5:
        assert np.isnan(want[[1, 4]]).all() and not np.isnan(want[[0, 2, 3]]).any()


def test_gather_rows_refuses_what_the_kernel_does_not_take():
    table = torch.zeros((8, 4))
    with pytest.raises(ValueError, match="int32"):
        gather_rows(table, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="float32"):
        gather_rows(table.double(), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\[R, C\]"):
        gather_rows(torch.zeros(8), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="no row-gather kernel"):
        gather_rows(torch.empty((8, 4), device="meta"),
                    torch.empty(3, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("kind", ["1d", "2d", "3d"])
def test_grid_samplers_match(kind):
    """Inside and outside [-1, 1]: the same gathers and lerp order on both
    sides, so only float rounding may differ."""
    rng = np.random.default_rng({"1d": 1, "2d": 2, "3d": 3}[kind])
    if kind == "1d":
        grid = rng.standard_normal((23, 16)).astype(np.float32)
        coords = rng.uniform(-1.3, 1.3, (7, 41)).astype(np.float32)
        fns = jgs.grid_sample_1d, tgs.grid_sample_1d
    elif kind == "2d":
        grid = rng.standard_normal((13, 17, 48)).astype(np.float32)
        coords = rng.uniform(-1.3, 1.3, (5, 67, 2)).astype(np.float32)
        fns = jgs.grid_sample_2d, tgs.grid_sample_2d
    else:
        grid = (rng.random((9, 11, 13)) < 0.4).astype(np.float32)
        coords = rng.uniform(-1.3, 1.3, (3, 301, 3)).astype(np.float32)
        fns = jgs.grid_sample_3d, tgs.grid_sample_3d
    coords[0, :3] = [-1.0, 1.0, 0.0] if kind == "1d" else coords[0, :3]
    want = np.asarray(fns[0](jnp.asarray(grid), jnp.asarray(coords)))
    got = fns[1](t(grid), t(coords)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# field features, alpha mask, compute_alpha
# ---------------------------------------------------------------------------


def test_field_features_match(fields):
    (jcfg, jp, jmask), (tcfg, tp, tmask) = fields
    assert tcfg == tfield.FieldConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(4)
    xyz = rng.uniform(-1.1, 1.1, (2, 257, 3)).astype(np.float32)
    for jf, tf in ((jfield.compute_densityfeature, tfield.compute_densityfeature),
                   (jfield.compute_appfeature, tfield.compute_appfeature)):
        want = np.asarray(jf(jcfg, jp, jnp.asarray(xyz)))
        got = tf(tcfg, tp, t(xyz)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **FEATURE_TOL)


def test_alpha_mask_and_compute_alpha_match(fields):
    (jcfg, jp, jmask), (tcfg, tp, tmask) = fields
    np.testing.assert_array_equal(tmask.volume.numpy(), np.asarray(jmask.volume))
    pts = np.concatenate([
        near_mask_points(jmask.volume, jcfg.aabb_np, 400, 5, spread=0.1),
        np.random.default_rng(6).uniform(-1.6, 1.6, (100, 3)).astype(np.float32),
    ])
    # the grid_sample_3d form, as the port computes it
    plain = jfield.AlphaMask(volume=jmask.volume, aabb=jmask.aabb)
    want = np.asarray(jfield.sample_alpha(plain, jnp.asarray(pts)))
    got = tfield.sample_alpha(tmask, t(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # the JAX package's packed-footprint form: the same > 0 decision
    packed = np.asarray(jfield.sample_alpha(jmask, jnp.asarray(pts)))
    np.testing.assert_array_equal(got > 0, packed > 0)
    assert 0 < (got > 0).mean() < 1

    for mask_j, mask_t in ((jmask, tmask), (None, None)):
        want = np.asarray(jrender.compute_alpha(jcfg, jp, mask_j,
                                                jnp.asarray(pts), 0.3))
        got = trender.compute_alpha(tcfg, tp, mask_t, t(pts), 0.3).numpy()
        np.testing.assert_allclose(got, want, **FEATURE_TOL)
        np.testing.assert_array_equal(got > 0, want > 0)


def test_power_transformation_and_unisphere_coords_match():
    xyz = np.random.default_rng(7).uniform(-3, 3, (99, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tfield.power_transformation(t(xyz)).numpy(),
        np.asarray(jfield.power_transformation(jnp.asarray(xyz))),
        rtol=1e-6, atol=1e-6)
    for ct in ("aabb", "unisphere"):
        jcfg = jfield.FieldConfig(contraction_type=ct)
        tcfg = tfield.FieldConfig(contraction_type=ct)
        np.testing.assert_allclose(
            tfield.normalize_coord(tcfg, t(xyz)).numpy(),
            np.asarray(jfield.normalize_coord(jcfg, jnp.asarray(xyz))),
            rtol=1e-6, atol=1e-6)
        assert (tcfg.step_size, tcfg.n_samples, tcfg.n_samples_bg) == (
            jcfg.step_size, jcfg.n_samples, jcfg.n_samples_bg)


# ---------------------------------------------------------------------------
# shading heads and render_rays
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["Ref", "MLP_Fea", "MLP_PE", "MLP",
                                  "MLP_GARF", "SH", "RGB"])
def test_shading_heads_match(mode):
    from iffnerf_tpu_torch.checkpoint import params_from_numpy

    if mode == "MLP_PE":
        # init_shading sizes this head for 3 + 12 + 3 + 12 + 27 = 57 inputs
        # (as the reference does) while its apply feeds 54: no raw pts
        jp = jshading.init_mlp_head(jax.random.PRNGKey(8), [54, 32, 32, 3])
    else:
        jp = jshading.init_shading(jax.random.PRNGKey(8), mode, 27, 2, 2, 2, 32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(9)
    feats = rng.standard_normal((333, 27)).astype(np.float32)
    dirs = unit(rng.standard_normal((333, 3)))
    pts = rng.uniform(-1, 1, (333, 3)).astype(np.float32)
    want, want_x = jshading.apply_shading(
        jp, mode, jnp.asarray(pts), jnp.asarray(dirs), jnp.asarray(feats),
        view_pe=2, pos_pe=2, fea_pe=2)
    got, got_x = tshading.apply_shading(tp, mode, t(pts), t(dirs), t(feats),
                                        view_pe=2, pos_pe=2, fea_pe=2)
    # float32 heads (sin/cos of 2^k-scaled inputs, the IDE recurrence)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert (got_x is None) == (want_x is None)
    if mode == "Ref":
        np.testing.assert_allclose(
            tshading.compute_normals(tp, mode, t(feats)).numpy(),
            np.asarray(jshading.compute_normals(jp, mode, jnp.asarray(feats))),
            atol=1e-6, rtol=1e-5)
    else:
        with pytest.raises(ValueError, match="Ref"):
            tshading.compute_normals(tp, mode, t(feats))


@pytest.mark.parametrize("sample_mode", ["point_color", "aabb"])
def test_render_rays_match(vm, sample_mode):
    """Rays near the mask: surface-centred point-colour rays, and rays
    from outside the AABB aimed at occupied voxels."""
    (jcfg, jp, jmask), (tcfg, tp, tmask) = vm
    rng = np.random.default_rng(10)
    target = near_mask_points(jmask.volume, jcfg.aabb_np, 300, 11)
    if sample_mode == "point_color":
        ori, dirs = target, unit(rng.standard_normal((300, 3)))
    else:
        ori = unit(rng.standard_normal((300, 3))) * 4.0
        dirs = unit(target - ori)
    rays = np.concatenate([ori, dirs], -1).astype(np.float32)
    want = jrender.render_rays(jcfg, jp, jmask, jnp.asarray(rays),
                               white_bg=True, sample_mode=sample_mode)
    got = trender.render_rays(tcfg, tp, tmask, t(rays), white_bg=True,
                              sample_mode=sample_mode)
    for name, g, w in zip(("rgb", "depth", "acc", "alpha", "z_vals", "dists"),
                          got, want):
        # exp and cumprod along the ray, in another order: 1e-5
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    acc = got[2].numpy()
    assert (acc > 0.05).mean() > 0.5, "the rays must see the field"
    np.testing.assert_array_equal(
        trender.filtering_rays_bbox(tcfg, t(rays)).numpy(),
        np.asarray(jrender.filtering_rays_bbox(jcfg, jnp.asarray(rays))))


def test_render_rays_refuses_what_is_not_ported(vm):
    """NDC sampling is ported (tests/test_torch_ndc.py); the unisphere
    contraction and other samplers are not."""
    _, (tcfg, tp, tmask) = vm
    with pytest.raises(NotImplementedError, match="unisphere"):
        trender.render_rays(tcfg.replace(contraction_type="unisphere"), tp,
                            tmask, torch.zeros((2, 6)))
    with pytest.raises(NotImplementedError, match="infinity"):
        trender.render_rays(tcfg, tp, tmask, torch.zeros((2, 6)),
                            sample_mode="infinity")


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _assert_trees_equal(jtree, ttree):
    jleaves = jax.tree_util.tree_leaves_with_path(jtree)
    tleaves = jax.tree_util.tree_leaves(ttree)
    assert len(jleaves) == len(tleaves)
    for (path, a), b in zip(jleaves, tleaves):
        np.testing.assert_array_equal(f32(b), f32(a), err_msg=str(path))


def test_field_checkpoint_round_trip(vm, tmp_path):
    """JAX save_field -> port load_field keeps every leaf, the layout and
    the mask; port save_field -> JAX load_field gives the same back."""
    (jcfg, jp, jmask), (tcfg, tp, tmask) = vm
    _assert_trees_equal(jp, tp)
    assert tp["density_plane"][0].shape == (20, 20, 4)
    np.testing.assert_array_equal(tmask.aabb.numpy(), np.asarray(jmask.aabb))
    path = str(tmp_path / "port.npz")
    tckpt.save_field(path, tcfg, tp, tmask)
    cfg2, p2, m2 = jckpt.load_field(path)
    assert cfg2 == jcfg
    _assert_trees_equal(p2, tp)
    np.testing.assert_array_equal(np.asarray(m2.volume), np.asarray(jmask.volume))
    cfg3, p3, m3 = tckpt.load_field(path, device="cpu")
    assert cfg3 == tcfg and m3 is not None


def test_load_torch_checkpoint_matches(tmp_path):
    """A synthetic reference ``.th`` (VM planes [1, R, H, W] with H != W,
    lines [1, R, L, 1], Ref head, packed mask) through both converters."""
    rng = np.random.default_rng(12)
    g = (6, 7, 8)
    kw = dict(aabb=[[-1.5, -1.4, -1.3], [1.2, 1.5, 1.6]], gridSize=list(g),
              density_n_comp=[2, 3, 4], appearance_n_comp=[3, 4, 5],
              app_dim=27, shadingMode="Ref", near_far=[2.0, 6.0],
              density_shift=-10.0, alphaMask_thres=0.001, distance_scale=25.0,
              rayMarch_weight_thres=0.0001, pos_pe=6, view_pe=2, fea_pe=2,
              featureC=16, step_ratio=0.5, fea2denseAct="softplus")
    sd = {}
    mat, vec = ((0, 1), (0, 2), (1, 2)), (2, 1, 0)
    for kind, comps in (("density", kw["density_n_comp"]),
                        ("app", kw["appearance_n_comp"])):
        for i in range(3):
            m0, m1 = mat[i]
            sd[f"{kind}_plane.{i}"] = rng.standard_normal(
                (1, comps[i], g[m1], g[m0]))
            sd[f"{kind}_line.{i}"] = rng.standard_normal(
                (1, comps[i], g[vec[i]], 1))
    sd["basis_mat.weight"] = rng.standard_normal((27, 12))
    for name, (o, i_) in {"diffuse_color_mlp.0": (3, 27),
                          "tint_color_mlp.0": (3, 27),
                          "roughness_mlp.0": (1, 27),
                          "bottleneck_mlp": (16, 27),
                          "specular_mlp.0": (3, 16 + 38 + 1),
                          "normal_mlp.0": (3, 27)}.items():
        sd[f"renderModule.{name}.weight"] = rng.standard_normal((o, i_))
        sd[f"renderModule.{name}.bias"] = rng.standard_normal(o)
    vol = rng.random((5, 6, 7)) < 0.5
    ckpt = {"model_name": "TensorVMSplit", "kwargs": kw,
            "state_dict": {k: torch.from_numpy(v.astype(np.float32))
                           for k, v in sd.items()},
            "alphaMask.shape": vol.shape,
            "alphaMask.mask": np.packbits(vol.reshape(-1)),
            "alphaMask.aabb": torch.tensor(kw["aabb"])}
    path = str(tmp_path / "ref.th")
    torch.save(ckpt, path)
    jcfg, jp, jmask = jckpt.load_torch_checkpoint(path)
    tcfg, tp, tmask = tckpt.load_torch_checkpoint(path, device="cpu")
    assert tcfg == tfield.FieldConfig(**dataclasses.asdict(jcfg))
    _assert_trees_equal(jp, tp)
    assert tp["density_plane"][0].shape == (g[1], g[0], 2)
    assert tp["app_line"][2].shape == (g[0], 5)
    np.testing.assert_array_equal(tmask.volume.numpy(), np.asarray(jmask.volume))
    np.testing.assert_array_equal(tmask.volume.numpy() > 0, vol)
    xyz = np.random.default_rng(13).uniform(-1, 1, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tfield.compute_appfeature(tcfg, tp, t(xyz)).numpy(),
        np.asarray(jfield.compute_appfeature(jcfg, jp, jnp.asarray(xyz))),
        **FEATURE_TOL)
