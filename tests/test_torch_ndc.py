"""Port parity for forward-facing (NDC) field training and rendering
against the JAX package: ``sample_ray_ndc``, ``render_rays(ndc_ray=True)``,
one NDC train step's gradients, the camera-path render
``evaluation_path``, and ``train_cli`` on the LLFF fixture scene
(``tests/test_loaders.py::llff_scene``) with ``--render_test 1
--render_path 1``.

The field has flower's head and uneven ranks (``configs/flower.txt``:
MLP_Fea shading, relu density, no positional encodings, ranks [16, 4, 4]
and [48, 12, 12]) on a small grid over the LLFF AABB; it is made by the
JAX package and reaches the port through its checkpoint bridge. The NDC
jitter is one uniform draw a sample: JAX's draw ``jax.random.uniform(key,
(N, n))`` is handed to the port. Every tolerance is stated beside its
test.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from iffnerf_tpu.checkpoint import load_field as jload_field
from iffnerf_tpu.checkpoint import save_field as jsave_field
from iffnerf_tpu.data import load_llff as jload_llff
from iffnerf_tpu.models import field as jfield
from iffnerf_tpu.models import render as jrender
from iffnerf_tpu.render import evaluation_path as jevaluation_path
from iffnerf_tpu.train import trainer as jtrainer
from iffnerf_tpu_torch import train_cli
from iffnerf_tpu_torch.checkpoint import _flatten, _numpy_leaves, load_field
from iffnerf_tpu_torch.data import load_llff
from iffnerf_tpu_torch.device import trainable
from iffnerf_tpu_torch.models import render as trender
from iffnerf_tpu_torch.render.renderer import evaluation_path
from iffnerf_tpu_torch.train import trainer as ttrainer

from tests.test_loaders import llff_scene  # noqa: F401
from torch_parity import t

N_SAMPLES = 48
# JAX's render_rays compiled once a case (its eager ops compile one by one,
# about 10 s on the CPU)
jrender_rays = jax.jit(jrender.render_rays, static_argnames=(
    "config", "is_train", "ndc_ray", "n_samples"))
CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "flower.txt")


@pytest.fixture(scope="module")
def flower(tmp_path_factory):
    """A 20x22x14 field over the LLFF AABB with flower's head and ranks,
    its density factors shifted so that relu(sigma) is about 1 (the rays
    see the field), a 60 % occupied alpha mask -> ((config, params, mask)
    of JAX, of the port)."""
    cfg = jfield.FieldConfig(
        aabb=((-1.5, -1.67, -1.0), (1.5, 1.67, 1.0)), grid_size=(20, 22, 14),
        density_n_comp=(16, 4, 4), app_n_comp=(48, 12, 12),
        shading_mode="MLP_Fea", fea2dense_act="relu", view_pe=0, fea_pe=0,
        near_far=(0.0, 1.0), step_ratio=0.5)
    # init_field's tree, drawn by numpy (JAX's eager init takes seconds):
    # factors N(0, 0.1), the density ones 3x + 0.3; weights N(0, 1/fan_in)
    rng = np.random.default_rng(7)

    def draw(path, leaf):
        top, last = path[0].key, getattr(path[-1], "key", None)
        if last == "b":
            return jnp.zeros(leaf.shape, jnp.float32)
        if last == "w":
            scale = leaf.shape[0] ** -0.5
        else:
            scale = 0.1
        a = rng.normal(0.0, scale, leaf.shape).astype(np.float32)
        if top.startswith("density"):
            a = 3.0 * a + np.float32(0.3)
        return jnp.asarray(a)

    shapes = jax.eval_shape(lambda k: jfield.init_field(k, cfg),
                            jax.random.PRNGKey(7))
    params = jax.tree_util.tree_map_with_path(draw, shapes)
    vol = np.random.default_rng(7).random((14, 22, 20)) < 0.6
    mask = jfield.make_alpha_mask(jnp.asarray(vol, jnp.float32), cfg.aabb_np)
    path = str(tmp_path_factory.mktemp("flower") / "field.npz")
    jsave_field(path, cfg, params, mask)
    return (cfg, params, mask), load_field(path, device="cpu")


@pytest.fixture(scope="module")
def rays(llff_scene):  # noqa: F811
    """256 NDC rays of the fixture's train split (every 37th)."""
    ds = load_llff(llff_scene, split="train", downsample=4.0)
    return ds.all_rays[::37][:256], ds.all_rgbs[::37][:256]


def test_sample_ray_ndc_matches_jax(flower, rays):
    """The samples, their depths and validity, unjittered and with JAX's
    jitter: within 1e-6 (the same float32 operations; linspace's
    arithmetic is jnp.linspace's)."""
    (jcfg, _, _), (tcfg, _, _) = flower
    r = rays[0]
    key = jax.random.PRNGKey(3)
    jitter = jax.random.uniform(key, (len(r), N_SAMPLES), jnp.float32)
    for is_train in (False, True):
        want = jrender.sample_ray_ndc(jcfg, jnp.asarray(r[:, :3]),
                                      jnp.asarray(r[:, 3:6]), key=key,
                                      is_train=is_train, n_samples=N_SAMPLES)
        got = trender.sample_ray_ndc(tcfg, t(r[:, :3]), t(r[:, 3:6]),
                                     jitter=t(jitter) if is_train else None,
                                     is_train=is_train, n_samples=N_SAMPLES)
        shapes = [(256, N_SAMPLES, 3), (256, N_SAMPLES), (256, N_SAMPLES)]
        for g, w, shape in zip(got, want, shapes):
            assert tuple(g.shape) == shape
            np.testing.assert_allclose(
                g.numpy(), np.broadcast_to(np.asarray(w), shape), rtol=0,
                atol=1e-6)
        assert 0.3 < float(got[2].float().mean()) < 1.0
    with pytest.raises(ValueError, match="generator"):
        trender.sample_ray_ndc(tcfg, t(r[:, :3]), t(r[:, 3:6]))


@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("is_train", [False, True])
def test_render_rays_ndc_matches_jax(flower, rays, with_mask, is_train):
    """rgb, depth, acc, alpha, z values and dists within 1e-5 (exp and
    cumprod along the ray in another order), eval and with JAX's jitter;
    ``sample_mode="ndc"`` is the same route."""
    (jcfg, jp, jmask), (tcfg, tp, tmask) = flower
    r = rays[0]
    key = jax.random.PRNGKey(4)
    want = jrender_rays(jcfg, jp, jmask if with_mask else None,
                        jnp.asarray(r), key=key, is_train=is_train,
                        ndc_ray=True, n_samples=N_SAMPLES)
    jitter = t(jax.random.uniform(key, (len(r), N_SAMPLES), jnp.float32))
    got = trender.render_rays(tcfg, tp, tmask if with_mask else None, t(r),
                              jitter=jitter if is_train else None,
                              is_train=is_train, ndc_ray=True,
                              n_samples=N_SAMPLES)
    for name, g, w in zip(("rgb", "depth", "acc", "alpha", "z_vals", "dists"),
                          got, want):
        w = np.broadcast_to(np.asarray(w), tuple(g.shape))
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    assert (got[2].numpy() > 0.05).mean() > 0.5, "the rays must see the field"
    again = trender.render_rays(tcfg, tp, tmask if with_mask else None, t(r),
                                jitter=jitter if is_train else None,
                                is_train=is_train, sample_mode="ndc",
                                n_samples=N_SAMPLES)
    for a, b in zip(again, got):
        assert torch.equal(a, b)


def _grads_tx():
    """An optax transformation whose state is the last gradients (and whose
    updates are zero): JAX's train step then returns its gradients."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(init, update)


def _flat(tree):
    return {k: np.asarray(v, np.float32)
            for k, v in _flatten(_numpy_leaves(tree)).items()}


def test_ndc_train_step_gradients_match_jax(flower, rays):
    """One NDC step on 256 fixture rays with the alpha mask, both TVs
    (flower's weights, 1.0) and the alpha term on, black background:
    every leaf's gradient within 1e-5 of its largest, the mse within rtol
    1e-5 (the rule of test_torch_train_loop's
    test_train_step_gradients_match_jax)."""
    (jcfg, jp, jmask), (tcfg, tp, tmask) = flower
    r, rgbs = rays
    weights = {"l1": 0.0, "tv_d": 1.0, "tv_a": 1.0}
    spec = dict(ortho_weight=0.0, use_l1=False, use_tv_density=True,
                use_tv_app=True)
    tx = _grads_tx()
    step = jtrainer.make_train_step(
        jcfg, tx, has_mask=True, n_samples=N_SAMPLES, ndc_ray=True,
        rgb_channels=3, **spec)
    key = jax.random.PRNGKey(5)
    jw = {k: jnp.float32(v) for k, v in weights.items()}
    jcopy = jax.tree_util.tree_map(jnp.array, jp)
    _, want, jmse = step(jcopy, tx.init(jcopy), jmask, jnp.asarray(r),
                         jnp.asarray(rgbs), jnp.arange(len(r)), key,
                         jnp.zeros(3), jw)

    params = trainable(tp, "cpu")
    total, mse = ttrainer.field_loss(
        tcfg, params, tmask, t(r), t(rgbs), torch.zeros(3), weights,
        n_samples=N_SAMPLES, ndc_ray=True,
        jitter=t(jax.random.uniform(key, (len(r), N_SAMPLES), jnp.float32)),
        **spec)
    total.backward()
    got = jax.tree_util.tree_map(lambda a: a.grad, params)
    assert float(mse.detach()) == pytest.approx(float(jmse), rel=1e-5)
    want, got = _flat(want), _flat(got)
    assert got.keys() == want.keys()
    for name, w in want.items():
        scale = float(np.abs(w).max())
        assert scale > 0, name
        err = float(np.abs(got[name] - w).max())
        assert err <= 1e-5 * scale, f"{name}: {err} > 1e-5 x {scale}"


def test_evaluation_path_matches_jax(flower, llff_scene):  # noqa: F811
    """Two spiral poses of the fixture's path at its test split's size,
    rendered as the JAX package renders a path with ``ndc_ray``: world
    rays with mip radii, not warped to NDC. The uint8 frames differ by at
    most 1 (rgb within 1e-5 rounds across a level) in under 1 % of the
    values."""
    (jcfg, jp, jmask), (tcfg, tp, tmask) = flower
    jds = jload_llff(llff_scene, split="test", is_stack=True)
    tds = load_llff(llff_scene, split="test", is_stack=True)
    want = jevaluation_path(jcfg, jp, jmask, jds.render_path[:2], jds,
                            n_samples=N_SAMPLES, ndc_ray=True)
    log = {}
    got = evaluation_path(tcfg, tp, tmask, tds.render_path[:2], tds,
                          n_samples=N_SAMPLES, ndc_ray=True, device="cpu",
                          log=log)
    assert len(got) == len(want) == 2 and len(log["seconds"]) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == (30, 40, 3) and g.dtype == np.uint8
        diff = np.abs(g.astype(int) - np.asarray(w).astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    assert np.ptp(np.stack(got)) > 0


def test_train_cli_trains_an_llff_scene(llff_scene, tmp_path,  # noqa: F811
                                        monkeypatch):
    """``train_cli --config configs/flower.txt`` on the fixture (NDC rays,
    flower's head, ranks and TV weights) cut to 12 iterations of 256
    rays: the mask update with its shrink at 4, an upsample 16^3 -> 20^3
    at 8, then ``--render_test 1 --render_path 1``. A finite test PSNR,
    the path's video written, no ray filter logged, and a field that the
    JAX package's ``load_field`` reads as the port wrote it. The
    TensorBoard writer is the trainer's no-op one (importing TensorBoard
    loads TensorFlow here, about 10 s), and torch runs on one thread (the
    run's thousands of small ops slow most when their threads contend with
    other test processes for the cores)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    lines = []
    argv = ["--config", CONFIG, "--datadir", llff_scene,
            "--basedir", str(tmp_path), "--expname", "fl", "--device", "cpu",
            "--n_iters", "12", "--batch_size", "256",
            "--N_voxel_init", str(16 ** 3), "--N_voxel_final", str(20 ** 3),
            "--upsamp_list", "8", "--update_AlphaMask_list", "4",
            "--downsample_train", "8", "--step_ratio", "2.0",
            "--N_vis", "0", "--progress_refresh_rate", "4",
            "--ckpt_every", "0", "--render_test", "1", "--render_path", "1"]
    args = train_cli.parse_args(argv)
    assert args.ndc_ray == 1 and args.dataset_name == "llff"
    assert args.shadingMode == "MLP_Fea" and args.n_lamb_sh == [48, 12, 12]
    cfg, params, mask, logfolder = ttrainer.reconstruction(
        args, log_fn=lines.append, device="cpu")
    psnr = [float(ln.split("psnr: ")[1].split(" ")[0]) for ln in lines
            if "test all psnr" in ln]
    assert len(psnr) == 1 and np.isfinite(psnr[0])
    assert not any("Ray filtering" in ln for ln in lines)
    assert mask is not None and np.prod(cfg.grid_size) > 0.9 * 20 ** 3
    path_dir = os.path.join(logfolder, "imgs_path_all")
    assert any(f.startswith("video") for f in os.listdir(path_dir))
    jcfg, jp, jmask = jload_field(os.path.join(logfolder, "fl.npz"))
    assert jcfg.grid_size == cfg.grid_size and jcfg.aabb == cfg.aabb
    assert jcfg.shading_mode == "MLP_Fea" and jcfg.fea2dense_act == "relu"
    np.testing.assert_array_equal(np.asarray(jmask.volume),
                                  mask.volume.numpy())
    for name, a in _flat(params).items():
        np.testing.assert_array_equal(_flat(jp)[name], a, err_msg=name)
