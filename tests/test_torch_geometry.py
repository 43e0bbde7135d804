"""The rest of the port's geometry, and the small exported functions,
against the JAX package on the CPU: each function of ``geometry/rays.py``,
the line-intersection solvers of ``pose/geometry.py`` (the cross-product
least squares, impl3, impl4 with its IRLS), ``srgb_to_linear``,
``eval_sh``, ``exclusive_transmittance``, the IDE coefficient tables and
``register_dataset``.

Inputs are drawn by numpy from a seed and given to both packages.
Tolerances: rtol 1e-5 and atol 1e-5 for the float32 ray and tone-mapping
arithmetic (the same operations, reductions in another order); the
solvers within 1e-4 of JAX's (a 3x3 pseudo-inverse by SVD in each
package: LAPACK's and XLA's); the coefficient tables exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (torch on one thread)
import iffnerf_tpu.data as jdata
import iffnerf_tpu.geometry as jgeometry_pkg
import iffnerf_tpu.pose as jpose
from iffnerf_tpu.geometry import rays as jrays
from iffnerf_tpu.ops import ide as jide
from iffnerf_tpu.ops import image as jimage
from iffnerf_tpu.ops import ray_march as jmarch
from iffnerf_tpu.ops import sh as jsh
from iffnerf_tpu.pose import geometry as jgeo
import iffnerf_tpu_torch.data as tdata
import iffnerf_tpu_torch.geometry as tgeometry_pkg
import iffnerf_tpu_torch.pose as tpose
from iffnerf_tpu_torch.geometry import rays as trays
from iffnerf_tpu_torch.ops import ide as tide
from iffnerf_tpu_torch.ops import image as timage
from iffnerf_tpu_torch.ops import ray_march as tmarch
from iffnerf_tpu_torch.ops import sh as tsh
from iffnerf_tpu_torch.pose import geometry as tgeo

RTOL = ATOL = 1e-5
SOLVER_TOL = 1e-4
H, W = 6, 8


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol)


def _c2w(rng, batch=()):
    q, _ = np.linalg.qr(rng.standard_normal(batch + (3, 3)))
    c2w = np.zeros(batch + (4, 4), np.float32)
    c2w[..., :3, :3] = q
    c2w[..., :3, 3] = rng.standard_normal(batch + (3,))
    c2w[..., 3, 3] = 1.0
    return c2w


def _k(rng, batch=1):
    k = np.zeros((batch, 3, 3), np.float32)
    k[:, 0, 0] = rng.uniform(5, 9, batch)
    k[:, 1, 1] = rng.uniform(5, 9, batch)
    k[:, 0, 2], k[:, 1, 2], k[:, 2, 2] = W / 2, H / 2, 1.0
    return k


def _tt(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jj(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_geometry_exports_follow_jax():
    public = [n for n in dir(jgeometry_pkg) if not n.startswith("_")
              and callable(getattr(jgeometry_pkg, n))]
    assert public and all(callable(getattr(tgeometry_pkg, n)) for n in public)
    for name in ("compute_line_intersection",
                 "compute_line_intersection_impl3",
                 "compute_line_intersection_impl4"):
        assert callable(getattr(jpose, name)) and callable(getattr(tpose, name))
    jfuncs = {n for n in dir(jrays) if callable(getattr(jrays, n))
              and getattr(getattr(jrays, n), "__module__", "") == jrays.__name__}
    assert jfuncs <= set(dir(trays))


def _case_cast_rays(rng):
    ori, dirs = rng.standard_normal((2, 5, 3)).astype(np.float32)
    z = rng.uniform(0, 4, (5, 7)).astype(np.float32)
    return (trays.cast_rays(*_tt(ori, dirs, z)),
            jrays.cast_rays(*_jj(ori, dirs, z)))


def _case_directions(rng, fn):
    focal = [float(rng.uniform(5, 9)), float(rng.uniform(5, 9))]
    out = []
    for center, pc in ((None, True), ((3.5, 2.0), False)):
        out.append((getattr(trays, fn)(H, W, focal, center, pc),
                    getattr(jrays, fn)(H, W, focal, center, pc)))
    return [a for a, _ in out], [b for _, b in out]


def _case_directions_ks(rng):
    k = _k(rng, 2)
    return (trays.get_ray_directions_Ks(H, W, torch.from_numpy(k)),
            jax.jit(lambda a: jrays.get_ray_directions_Ks(H, W, a))(k))


def _case_get_rays(rng):
    vd = rng.standard_normal((H, W, 3)).astype(np.float32)
    dx, dy, dd = (vd + 0.01 * rng.standard_normal((3, H, W, 3))
                  ).astype(np.float32)
    c2w = _c2w(rng)
    got = [trays.get_rays(*_tt(vd, c2w)),
           trays.get_rays(*_tt(vd, c2w), keepdim=True),
           trays.get_rays(*_tt(vd, c2w), directions=torch.from_numpy(dd),
                          dx=torch.from_numpy(dx), dy=torch.from_numpy(dy))]
    want = [jax.jit(jrays.get_rays)(*_jj(vd, c2w)),
            jax.jit(lambda v, c: jrays.get_rays(v, c, keepdim=True))(vd, c2w),
            jax.jit(jrays.get_rays)(*_jj(vd, c2w), directions=jnp.asarray(dd),
                                    dx=jnp.asarray(dx), dy=jnp.asarray(dy))]
    return [t for g in got for t in g], [t for w in want for t in w]


def _case_get_rays_lie(rng):
    vd = rng.standard_normal((H, W, 3)).astype(np.float32)
    c2w = _c2w(rng)
    rot, trans = c2w[:3, :3].copy(), c2w[:3, 3].copy()
    return (trays.get_rays_lie(*_tt(vd, rot, trans)),
            jrays.get_rays_lie(*_jj(vd, rot, trans)))


def _case_get_rays_simple(rng):
    d = rng.standard_normal((H, W, 3)).astype(np.float32)
    c2w = _c2w(rng)[:3]
    return (trays.get_rays_simple(*_tt(d, c2w)),
            jrays.get_rays_simple(*_jj(d, c2w)))


def _case_get_rays_from_parameters(rng):
    k, c2w = _k(rng, 1), _c2w(rng, (1,))
    return (trays.get_rays_from_parameters(H, W, *_tt(k, c2w)),
            jax.jit(lambda a, b: jrays.get_rays_from_parameters(H, W, a, b))(
                k, c2w))


def _case_ndc(rng):
    o = rng.standard_normal((20, 3)).astype(np.float32)
    o[:, 2] = rng.uniform(-3, -1, 20)
    d = rng.standard_normal((20, 3)).astype(np.float32)
    d[:, 2] = -rng.uniform(0.5, 1.5, 20)
    return (trays.ndc_rays_blender(H, W, 7.0, 1.0, *_tt(o, d)),
            jrays.ndc_rays_blender(H, W, 7.0, 1.0, *_jj(o, d)))


def _case_sample_pdf(rng):
    bins = np.sort(rng.uniform(0, 4, (5, 9)), -1).astype(np.float32)
    weights = rng.uniform(0, 1, (5, 8)).astype(np.float32)
    weights[0] = 0.0
    key = jax.random.PRNGKey(3)
    ju = jax.random.uniform(key, (5, 11), jnp.float32)
    got = [trays.sample_pdf(None, *_tt(bins, weights), 11, det=True),
           trays.sample_pdf(None, *_tt(bins, weights), 11,
                            u=torch.from_numpy(np.array(ju)))]
    want = [jax.jit(lambda b, w: jrays.sample_pdf(None, b, w, 11, det=True))(
                bins, weights),
            jax.jit(lambda k, b, w: jrays.sample_pdf(k, b, w, 11))(
                key, bins, weights)]
    drawn = trays.sample_pdf(torch.Generator().manual_seed(0),
                             *_tt(bins, weights), 11)
    assert drawn.shape == (5, 11) and bool(
        ((drawn >= bins.min()) & (drawn <= bins.max())).all())
    return got, want


def _case_depth2dist(rng):
    z = np.sort(rng.uniform(0, 4, (5, 7)), -1).astype(np.float32)
    cos = rng.uniform(0.5, 1, 5).astype(np.float32)
    return (trays.depth2dist(*_tt(z, cos)), jrays.depth2dist(*_jj(z, cos)))


def _case_ndc2dist(rng):
    pts = rng.standard_normal((5, 7, 3)).astype(np.float32)
    cos = rng.uniform(0.5, 1, 5).astype(np.float32)
    return (trays.ndc2dist(*_tt(pts, cos)), jrays.ndc2dist(*_jj(pts, cos)))


def _case_dda(rng):
    o = rng.uniform(-3, 3, (20, 3)).astype(np.float32)
    d = rng.standard_normal((20, 3)).astype(np.float32)
    box = np.array([[-1, -1.2, -0.8], [1, 0.9, 1.1]], np.float32)
    return trays.dda(*_tt(o, d, box)), jrays.dda(*_jj(o, d, box))


def _case_ray_marcher(rng):
    rays = rng.standard_normal((6, 8)).astype(np.float32)
    rays[:, 6] = rng.uniform(1, 2, 6)
    rays[:, 7] = rng.uniform(3, 5, 6)
    box = np.array([[-1, -1, -1], [1, 1, 1]], np.float32)
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.uniform(key, (6, 9), jnp.float32))
    got = [trays.ray_marcher(torch.from_numpy(rays), 9),
           trays.ray_marcher(torch.from_numpy(rays), 9, lindisp=True),
           trays.ray_marcher(torch.from_numpy(rays), 9,
                             bbox_3d=torch.from_numpy(box)),
           trays.ray_marcher(torch.from_numpy(rays), 9, perturb=1.0,
                             noise=torch.from_numpy(noise))]
    want = [jax.jit(lambda r: jrays.ray_marcher(r, 9))(rays),
            jax.jit(lambda r: jrays.ray_marcher(r, 9, lindisp=True))(rays),
            jax.jit(lambda r, b: jrays.ray_marcher(r, 9, bbox_3d=b))(rays, box),
            jax.jit(lambda r, k: jrays.ray_marcher(r, 9, perturb=1.0, key=k))(
                rays, key)]
    return [t for g in got for t in g], [t for w in want for t in w]


RAY_CASES = {
    "cast_rays": _case_cast_rays,
    "get_ray_directions": lambda r: _case_directions(r, "get_ray_directions"),
    "get_ray_directions_blender":
        lambda r: _case_directions(r, "get_ray_directions_blender"),
    "get_ray_directions_Ks": _case_directions_ks,
    "get_rays": _case_get_rays,
    "get_rays_lie": _case_get_rays_lie,
    "get_rays_simple": _case_get_rays_simple,
    "get_rays_from_parameters": _case_get_rays_from_parameters,
    "ndc_rays_blender": _case_ndc,
    "sample_pdf": _case_sample_pdf,
    "depth2dist": _case_depth2dist,
    "ndc2dist": _case_ndc2dist,
    "dda": _case_dda,
    "ray_marcher": _case_ray_marcher,
}


@pytest.mark.parametrize("name", list(RAY_CASES))
def test_rays_match_jax(name):
    got, want = RAY_CASES[name](np.random.default_rng(len(name)))
    _close(got, want)


@pytest.mark.parametrize("color", [False, True])
def test_read_pfm_matches_jax(tmp_path, color):
    rng = np.random.default_rng(7)
    img = rng.standard_normal((4, 5, 3) if color else (4, 5)).astype("<f4")
    path = os.path.join(tmp_path, "d.pfm")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(b"5 4\n-2.5\n")
        f.write(np.flipud(img).tobytes())
    got, scale = trays.read_pfm(path)
    want, jscale = jrays.read_pfm(path)
    assert scale == jscale == 2.5
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)


def _rays_to(center, rng, n=30, noise=0.005):
    points = rng.standard_normal((n, 3)).astype(np.float32)
    dirs = center - points
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs += noise * rng.standard_normal(dirs.shape).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return points, dirs.astype(np.float32)


SOLVERS = ["compute_line_intersection", "compute_line_intersection_impl3",
           "compute_line_intersection_impl4"]


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("weighted", [False, True])
def test_line_intersection_solvers_match_jax(solver, weighted):
    """tests/test_pose_geometry.py's rays to a centre, with and without
    weights, and a parallel pair (a zeroed row)."""
    rng = np.random.default_rng(24)
    center = np.array([-0.4, 0.9, 1.3], np.float32)
    points, dirs = _rays_to(center, rng)
    # a parallel pair on one line: the cross-product row is zeroed
    dirs[5] = dirs[4]
    points[5] = points[4] + 0.3 * dirs[4]
    weights = (rng.uniform(0.5, 1.0, 30).astype(np.float32) if weighted
               else None)
    args_t = _tt(points, dirs) + ([] if weights is None else _tt(weights))
    args_j = _jj(points, dirs) + ([] if weights is None else _jj(weights))
    got = getattr(tgeo, solver)(*args_t)
    want = np.asarray(jax.jit(getattr(jgeo, solver))(*args_j))
    np.testing.assert_allclose(got.numpy(), want, rtol=SOLVER_TOL,
                               atol=SOLVER_TOL)
    np.testing.assert_allclose(got.numpy(), center, atol=0.05)


def test_impl4_resists_an_outlier_as_jax():
    """impl4's outlier case of tests/test_pose_geometry.py: one ray turned
    to +x; the IRLS solution stays at the centre, as JAX's."""
    rng = np.random.default_rng(24)
    center = np.array([-0.4, 0.9, 1.3], np.float32)
    points, dirs = _rays_to(center, rng)
    dirs[7] = np.array([1.0, 0.0, 0.0], np.float32)
    got = tgeo.compute_line_intersection_impl4(*_tt(points, dirs))
    want = np.asarray(jgeo.compute_line_intersection_impl4(*_jj(points, dirs)))
    np.testing.assert_allclose(got.numpy(), want, rtol=SOLVER_TOL,
                               atol=SOLVER_TOL)
    np.testing.assert_allclose(got.numpy(), center, atol=0.05)


@pytest.mark.parametrize("maxiter", [0, 1, 3, 100])
def test_irls_matches_jax(maxiter):
    """The flag that stands for the JAX loop's early exit: the same
    solution after any number of rounds."""
    rng = np.random.default_rng(31)
    x = rng.standard_normal((25, 3)).astype(np.float32)
    y = (x @ np.array([0.5, -1.0, 2.0], np.float32)
         + 0.01 * rng.standard_normal(25)).astype(np.float32)
    y[3] += 5.0
    got = tgeo._irls(*_tt(y, x), maxiter=maxiter)
    want = np.asarray(jgeo._irls(*_jj(y, x), maxiter=maxiter))
    np.testing.assert_allclose(got.numpy(), want, rtol=SOLVER_TOL,
                               atol=SOLVER_TOL)


def test_singular_systems_follow_jax():
    """impl3's minimum-norm solution for a singular projector sum (all
    rays parallel), and the cross-product solver's ones for an all-zero
    system, as JAX's."""
    points = np.random.default_rng(2).standard_normal((6, 3)).astype(np.float32)
    dirs = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (6, 1))
    for solver in ("compute_line_intersection_impl3",
                   "compute_line_intersection"):
        got = getattr(tgeo, solver)(*_tt(points, dirs))
        want = np.asarray(jax.jit(getattr(jgeo, solver))(*_jj(points, dirs)))
        np.testing.assert_allclose(got.numpy(), want, rtol=SOLVER_TOL,
                                   atol=SOLVER_TOL)


def test_cross_product_system_matches_jax():
    rng = np.random.default_rng(9)
    points, dirs = _rays_to(np.zeros(3, np.float32), rng, n=12)
    dirs[3] = dirs[2]
    w = rng.uniform(0.5, 1, 12).astype(np.float32)
    _close(tgeo._cross_product_system(*_tt(points, dirs, w)),
           jax.jit(jgeo._cross_product_system)(*_jj(points, dirs, w)))


def test_srgb_to_linear_matches_jax():
    x = np.linspace(-0.1, 1.1, 301, dtype=np.float32)
    _close(timage.srgb_to_linear(torch.from_numpy(x)),
           jimage.srgb_to_linear(jnp.asarray(x)))
    _close(timage.srgb_to_linear(torch.from_numpy(x), eps=1e-3),
           jimage.srgb_to_linear(jnp.asarray(x), eps=1e-3))


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    dirs = rng.standard_normal((10, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    sh = rng.standard_normal((10, 3, (deg + 1) ** 2)).astype(np.float32)
    _close(tsh.eval_sh(deg, *_tt(sh, dirs)), jsh.eval_sh(deg, *_jj(sh, dirs)))


def test_exclusive_transmittance_matches_jax():
    alpha = np.random.default_rng(3).uniform(0, 1, (4, 9)).astype(np.float32)
    _close(tmarch.exclusive_transmittance(torch.from_numpy(alpha)),
           jmarch.exclusive_transmittance(jnp.asarray(alpha)))


@pytest.mark.parametrize("deg", [1, 2, 3, 4, 5])
def test_ide_coefficient_tables_match_jax(deg):
    ml, mat = tide.integrated_dir_enc_coeffs(deg)
    jml, jmat = jide.integrated_dir_enc_coeffs(deg)
    np.testing.assert_array_equal(ml, jml)
    np.testing.assert_array_equal(mat, jmat)
    for l in (1, 2, 4):
        for m in range(l + 1):
            assert tide._generalized_binomial_coeff(0.5 * l, m) == \
                jide._generalized_binomial_coeff(0.5 * l, m)
            for k in range(l - m + 1):
                assert tide._assoc_legendre_coeff(l, m, k) == \
                    jide._assoc_legendre_coeff(l, m, k)
                assert tide._sph_harm_coeff(l, m, k) == \
                    jide._sph_harm_coeff(l, m, k)


def test_register_dataset_follows_jax():
    assert set(tdata.dataset_dict) == set(jdata.dataset_dict)

    def loader(*a, **k):
        return None

    tdata.register_dataset("probe_dataset", loader)
    try:
        assert tdata.dataset_dict["probe_dataset"] is loader
    finally:
        del tdata.dataset_dict["probe_dataset"]
