"""Port parity for the unisphere contraction against the JAX package:
``sample_ray``'s unisphere steps, ``sample_ray_infinity``,
``power_transformation_inv``, ``render_rays`` on a unisphere field, and a
two-iteration ``train_cli --contraction_type unisphere`` run on the
fixture scene.

The field has ``torch_parity.field``'s widths, its leaves drawn by numpy
and read back through both packages' ``load_field`` (so that both alpha
masks carry the contraction), over a box of half-extent 3: the power
contraction maps its outer samples beyond [-1, 1], where the grid
samplers read zeros. The
jitter is JAX's own draw ``jax.random.uniform(key, ...)`` handed to the
port. The tolerance is rtol 1e-5 and atol 1e-6 throughout (the same
float32 operations; exp and cumprod along the ray in another order).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iffnerf_tpu.models import field as jfield
from iffnerf_tpu.models import render as jrender
from iffnerf_tpu_torch import train_cli
from iffnerf_tpu_torch.models import field as tfield
from iffnerf_tpu_torch.models import render as trender

from torch_parity import drawn_field, t

TOL = dict(rtol=1e-5, atol=1e-6)
BOX = ((-3.0, -3.0, -3.0), (3.0, 3.0, 3.0))
jrender_rays = jax.jit(jrender.render_rays, static_argnames=(
    "config", "is_train", "ndc_ray", "n_samples"))


@pytest.fixture(scope="module")
def sphere(tmp_path_factory):
    """A 20^3 unisphere field over BOX with ``torch_parity.field``'s widths
    (ranks 4 and 8, Ref shading, PE 2, density_shift -1; step_ratio 0.5:
    32 samples in the box and 40 of the background a ray), its leaves
    drawn by numpy (``torch_parity.drawn_field``), a 30 % occupied alpha
    mask -> ((config, params, mask) of JAX, of the port), both read from
    one checkpoint, both masks carrying the contraction."""
    cfg = jfield.FieldConfig(
        aabb=BOX, grid_size=(20, 20, 20), density_n_comp=(4, 4, 4),
        app_n_comp=(8, 8, 8), app_dim=27, shading_mode="Ref", view_pe=2,
        fea_pe=2, pos_pe=2, density_shift=-1.0, contraction_type="unisphere",
        step_ratio=0.5)
    vol = np.random.default_rng(3).random((16, 18, 20)) < 0.3
    mask = jfield.make_alpha_mask(jnp.asarray(vol, jnp.float32), cfg.aabb_np,
                                  "unisphere")
    jax_side, port = drawn_field(
        tmp_path_factory.mktemp("unisphere") / "field.npz", cfg, 3,
        mask=mask)
    assert port[2].unisphere and jax_side[2].unisphere
    return jax_side, port


@pytest.fixture(scope="module")
def rays():
    """256 rays [N, 6] from a sphere of radius 5 towards points near the
    centre, their directions unit."""
    rng = np.random.default_rng(11)
    o = rng.standard_normal((256, 3))
    o = 5.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-0.8, 0.8, (256, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d], -1).astype(np.float32)


def test_sample_ray_unisphere_matches_jax(sphere, rays):
    """The samples, their depths and validity, unjittered and with JAX's
    jitter; the background steps are step_size_bg long."""
    (jcfg, _, _), (tcfg, _, _) = sphere
    n = tcfg.n_samples + tcfg.n_samples_bg
    assert (tcfg.n_samples, tcfg.n_samples_bg) == (32, 40)
    key = jax.random.PRNGKey(5)
    jitter = jax.random.uniform(key, (len(rays), 1), jnp.float32)
    for is_train in (False, True):
        want = jrender.sample_ray(jcfg, jnp.asarray(rays[:, :3]),
                                  jnp.asarray(rays[:, 3:6]), key=key,
                                  is_train=is_train)
        got = trender.sample_ray(tcfg, t(rays[:, :3]), t(rays[:, 3:6]),
                                 jitter=t(jitter) if is_train else None,
                                 is_train=is_train)
        for g, w, shape in zip(got, want, [(256, n, 3), (256, n), (256, n)]):
            assert tuple(g.shape) == shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        assert 0.1 < float(got[2].float().mean()) < 0.9
    z = got[1].numpy()
    k = tcfg.n_samples + 1
    np.testing.assert_allclose((z[:, k + 1] - z[:, k]), tcfg.step_size_bg,
                               rtol=1e-4)


def test_sample_ray_infinity_matches_jax(sphere, rays):
    """Inverse-depth samples from 1 / near, unjittered and with JAX's
    jitter (clipped to [1e-8, 1])."""
    (jcfg, _, _), (tcfg, _, _) = sphere
    n = 24
    key = jax.random.PRNGKey(6)
    jitter = jax.random.uniform(key, (len(rays), n), jnp.float32)
    for cfg_j, cfg_t in ((jcfg, tcfg), (jcfg.replace(near_far=(0.1, 6.0)),
                                        tcfg.replace(near_far=(0.1, 6.0)))):
        for is_train in (False, True):
            want = jrender.sample_ray_infinity(
                cfg_j, jnp.asarray(rays[:, :3]), jnp.asarray(rays[:, 3:6]),
                key=key, is_train=is_train, n_samples=n)
            got = trender.sample_ray_infinity(
                cfg_t, t(rays[:, :3]), t(rays[:, 3:6]),
                jitter=t(jitter) if is_train else None, is_train=is_train,
                n_samples=n)
            for g, w, shape in zip(got, want, [(256, n, 3), (256, n),
                                               (256, n)]):
                assert tuple(g.shape) == shape
                np.testing.assert_allclose(
                    g.numpy(), np.broadcast_to(np.asarray(w), shape), **TOL)
    with pytest.raises(ValueError, match="generator"):
        trender.sample_ray_infinity(tcfg, t(rays[:, :3]), t(rays[:, 3:6]))


def test_power_transformation_inv_matches_jax():
    """The inverse contraction on (-5/3, 5/3), and its round trip through
    ``power_transformation`` on world offsets up to 20."""
    rng = np.random.default_rng(8)
    c = rng.uniform(-1.66, 1.66, (999, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tfield.power_transformation_inv(t(c)).numpy(),
        np.asarray(jfield.power_transformation_inv(jnp.asarray(c))), **TOL)
    for alpha in (-1.5, -2.0):
        np.testing.assert_allclose(
            tfield.power_transformation_inv(t(c) / 2, alpha).numpy(),
            np.asarray(jfield.power_transformation_inv(jnp.asarray(c) / 2,
                                                       alpha)), **TOL)
    x = rng.uniform(-20, 20, (999, 3)).astype(np.float32)
    back = tfield.power_transformation_inv(tfield.power_transformation(t(x)))
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("is_train", [False, True])
def test_render_rays_unisphere_matches_jax(sphere, rays, with_mask,
                                           is_train):
    """rgb, depth, acc, alpha, z values and dists, eval and with JAX's
    jitter, with and without the unisphere alpha mask."""
    (jcfg, jp, jmask), (tcfg, tp, tmask) = sphere
    key = jax.random.PRNGKey(4)
    want = jrender_rays(jcfg, jp, jmask if with_mask else None,
                        jnp.asarray(rays), key=key, is_train=is_train)
    jitter = t(jax.random.uniform(key, (len(rays), 1), jnp.float32))
    got = trender.render_rays(tcfg, tp, tmask if with_mask else None,
                              t(rays), jitter=jitter if is_train else None,
                              is_train=is_train)
    for name, g, w in zip(("rgb", "depth", "acc", "alpha", "z_vals", "dists"),
                          got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)
    assert (got[2].numpy() > 0.05).mean() > 0.3, "the rays must see the field"


def test_train_cli_trains_unisphere(tmp_path, monkeypatch):
    """``train_cli --contraction_type unisphere`` on the fixture scene, 2
    iterations of 256 rays on a 10^3 grid with a mask update after the
    first: finite losses, and the saved field carries the contraction into
    its alpha mask."""
    from fixtures import make_blender_fixture
    from iffnerf_tpu_torch.checkpoint import load_field
    from iffnerf_tpu_torch.train import trainer

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    scene = make_blender_fixture(str(tmp_path / "scene"), n_train=2,
                                 n_test=1, wh=24)
    args = train_cli.parse_args(
        ["--datadir", scene, "--basedir", str(tmp_path), "--expname", "uni",
         "--device", "cpu", "--contraction_type", "unisphere",
         "--n_iters", "2", "--batch_size", "256", "--N_voxel_init",
         str(8 ** 3), "--N_voxel_final", str(10 ** 3), "--upsamp_list", "100",
         "--update_AlphaMask_list", "1", "--shadingMode", "Ref",
         "--progress_refresh_rate", "1", "--N_vis", "0", "--ckpt_every", "0",
         "--render_test", "0"])
    lines = []
    _, _, _, logfolder = trainer.reconstruction(args, log_fn=lines.append,
                                                device="cpu")
    mses = [float(ln.split("mse ")[1]) for ln in lines if " mse " in ln]
    assert len(mses) == 2 and all(np.isfinite(mses))
    cfg, _, mask = load_field(os.path.join(logfolder, "uni.npz"),
                              device="cpu")
    assert cfg.contraction_type == "unisphere" and mask.unisphere
    assert cfg.n_samples_bg > 0
