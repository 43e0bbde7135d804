"""Port parity for field training's loop (``iffnerf_tpu_torch/train`` and
``render/``, ``train_cli.py``) against the JAX package's ``train/`` and
``render/``: the batch sampler, the optimizer and its decay, one train
step's gradients, the ray filter, and a short ``reconstruction`` on the
fixture scene (``tests/fixtures.py``) with its checkpoint, resume and the
CLI's render-only route.

The JAX step's gradients are read through its own ``make_train_step`` with
an optax transformation that keeps them as its state; its jitter is the
draw ``jax.random.uniform(step_key, (N, 1))`` handed to the port. Every
tolerance is stated beside its test.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from iffnerf_tpu.checkpoint import load_field as jload_field
from iffnerf_tpu.config import config_parser as jconfig_parser
from iffnerf_tpu.data import load_blender as jload_blender
from iffnerf_tpu.render import evaluation as jevaluation
from iffnerf_tpu.train import trainer as jtrainer
from iffnerf_tpu_torch import train_cli
from iffnerf_tpu_torch.checkpoint import _flatten, _numpy_leaves, load_field
from iffnerf_tpu_torch.config import config_parser
from iffnerf_tpu_torch.data import load_blender
from iffnerf_tpu_torch.device import trainable
from iffnerf_tpu_torch.render.renderer import evaluation
from iffnerf_tpu_torch.train import trainer as ttrainer

from torch_parity import field, jax_child, near_mask_points, t, unit

CPU = torch.device("cpu")
# a shortened fixture schedule: 16^3 -> 24^3, 200 iterations of 512 rays,
# the mask updates (with the shrink, then the ray filter) at 60 and 140,
# the upsample at 100
FLAGS = ["--n_iters", "200", "--batch_size", "512",
         "--N_voxel_init", str(16 ** 3), "--N_voxel_final", str(24 ** 3),
         "--upsamp_list", "100", "--update_AlphaMask_list", "60",
         "--update_AlphaMask_list", "140", "--shadingMode", "Ref",
         "--view_pe", "2", "--fea_pe", "2", "--L1_weight_inital", "8e-5",
         "--L1_weight_rest", "4e-5", "--rm_weight_mask_thre", "1e-3",
         "--N_vis", "0", "--vis_every", "100000", "--step_ratio", "0.5",
         "--progress_refresh_rate", "50", "--ckpt_every", "0"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from fixtures import make_blender_fixture

    return make_blender_fixture(str(tmp_path_factory.mktemp("fx")),
                                n_train=10, n_test=2, wh=48)


@pytest.fixture(scope="module")
def vm(tmp_path_factory):
    return field(tmp_path_factory.mktemp("loop_vm"), seed=6,
                 grid_size=(20, 20, 20), step_ratio=0.5)


def _flat(tree):
    return {k: np.asarray(v, np.float32)
            for k, v in _flatten(_numpy_leaves(tree)).items()}


def _grads_tx():
    """An optax transformation whose state is the last gradients (and whose
    updates are zero): JAX's train step then returns its gradients."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(init, update)


def test_sampler_indices_match_jax():
    """numpy in both: the same permutations, epoch after epoch."""
    js, ts = jtrainer.SimpleSampler(1000, 96, 7), ttrainer.SimpleSampler(
        1000, 96, 7)
    for _ in range(25):
        np.testing.assert_array_equal(ts.nextids(), js.nextids())


def test_adam_updates_match_optax(vm):
    """Three Adam updates with the decaying rate, on the same gradients,
    both groups: every parameter within 1e-3 of its group's rate of JAX's
    (float32 rounding of m / (sqrt(v) + eps), a step of about the rate)."""
    (_, jp, _), (_, tp, _) = vm
    lr_s, lr_n, factor = 0.02, 1e-3, 0.5
    state = jtrainer.make_optimizer(jp, lr_s, lr_n, factor)
    jparams, opt_state = jp, state.opt_state
    params = trainable(tp, CPU)
    opt = ttrainer.make_optimizer(params, lr_s, lr_n, factor)
    rng = np.random.default_rng(0)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: np.asarray(rng.standard_normal(a.shape) * 10 ** -step,
                                 np.float32), jparams)
        updates, opt_state = state.tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(jax.tree_util.tree_leaves(params),
                        jax.tree_util.tree_leaves(grads)):
            p.grad = torch.from_numpy(np.array(g))
        opt.step()
    want, got = _flat(jparams), _flat(params)
    for name, w in want.items():
        lr = lr_n if name.split("/")[0] in ttrainer.NETWORK else lr_s
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-3 * lr,
                                   err_msg=name)
    assert opt.count == 3
    assert opt.adam.param_groups[0]["lr"] == pytest.approx(lr_s * factor ** 2)


def _batch(jcfg, jmask, n, seed):
    rng = np.random.default_rng(seed)
    target = near_mask_points(jmask.volume, jcfg.aabb_np, n, seed + 1)
    ori = unit(rng.standard_normal((n, 3))) * 4.0
    rays = np.concatenate([ori, unit(target - ori),
                           np.full((n, 1), 1e-3, np.float32)], -1)
    rgbs = rng.random((n, 4), dtype=np.float32)
    return rays.astype(np.float32), rgbs


@pytest.mark.parametrize("with_mask", [True, False])
def test_train_step_gradients_match_jax(vm, with_mask):
    """One fixed batch (256 rays at the mask, RGBA targets on white) with
    every term on: ortho, L1, both TVs and the alpha term. JAX's step
    gradients against the port's within 1e-5 of each leaf's largest
    (dense float32 marches and sums in another order), and the mse within
    rtol 1e-5."""
    (jcfg, jp, jmask), (tcfg, tp, tmask) = vm
    rays, rgbs = _batch(jcfg, jmask, 256, 21)
    n_samples = 70
    weights = {"l1": 8e-5, "tv_d": 0.5, "tv_a": 0.25}
    spec = dict(ortho_weight=1e-3, use_l1=True, use_tv_density=True,
                use_tv_app=True)
    tx = _grads_tx()
    step = jtrainer.make_train_step(
        jcfg, tx, has_mask=with_mask, n_samples=n_samples, ndc_ray=False,
        rgb_channels=4, **spec)
    key = jax.random.PRNGKey(5)
    idx = jnp.arange(256)
    jw = {k: jnp.float32(v) for k, v in weights.items()}
    args = ((jmask,) if with_mask else ()) + (
        jnp.asarray(rays), jnp.asarray(rgbs), idx, key, jnp.ones(3), jw)
    # the step donates its parameters: hand it a copy
    jcopy = jax.tree_util.tree_map(jnp.array, jp)
    _, want, jmse = step(jcopy, tx.init(jcopy), *args)

    params = trainable(tp, CPU)
    total, mse = ttrainer.field_loss(
        tcfg, params, tmask if with_mask else None, t(rays), t(rgbs),
        torch.ones(3), weights, n_samples=n_samples,
        jitter=t(jax.random.uniform(key, (256, 1), jnp.float32)), **spec)
    total.backward()
    got = jax.tree_util.tree_map(lambda a: a.grad, params)
    assert float(mse) == pytest.approx(float(jmse), rel=1e-5)
    want, got = _flat(want), _flat(got)
    assert got.keys() == want.keys()
    for name, w in want.items():
        scale = float(np.abs(w).max())
        assert scale > 0, name
        err = float(np.abs(got[name] - w).max())
        assert err <= 1e-5 * scale, f"{name}: {err} > 1e-5 x {scale}"


def test_filtering_rays_matches_jax(scene, vm):
    """The AABB filter and the mask filter keep the JAX package's rows
    exactly (the same float32 slab test and mask lookups)."""
    (jcfg, _, jmask), (tcfg, _, tmask) = vm
    ds = jload_blender(scene, split="train", is_stack=False)
    rays, rgbs = ds.all_rays[::3], ds.all_rgbs[::3]
    for kw in (dict(bbox_only=True), dict(mask=None)):
        jr, jg = jtrainer.filtering_rays_host(
            jcfg, rays, rgbs, mask=jmask if "mask" in kw else None,
            bbox_only=kw.get("bbox_only", False), chunk=4000)
        tr, tg = ttrainer.filtering_rays_host(
            tcfg, rays, rgbs, mask=tmask if "mask" in kw else None,
            bbox_only=kw.get("bbox_only", False), chunk=3000, device="cpu",
            log_fn=lambda *a: None)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        assert 0 < len(jr) <= len(rays)


def test_field_config_from_args_matches(scene):
    flags = ["--datadir", scene, "--n_lamb_sigma", "8",
             "--n_lamb_sh", "12", "--n_lamb_sh", "16", "--n_lamb_sh", "20"]
    jargs, targs = jconfig_parser(flags), config_parser(flags)
    aabb = [[-1.5, -1.2, -1.0], [1.5, 1.2, 1.0]]
    want = jtrainer.field_config_from_args(jargs, aabb, (30, 24, 20), (2, 6))
    got = ttrainer.field_config_from_args(targs, aabb, (30, 24, 20), (2, 6))
    assert got.aabb == want.aabb and got.grid_size == want.grid_size
    for name in ("density_n_comp", "app_n_comp", "app_dim", "shading_mode",
                 "near_far", "step_ratio", "alpha_mask_thres",
                 "ray_march_weight_thres", "units", "n_samples"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name


def jax_reference_run(scene, basedir):
    """The JAX package's reconstruction of the shortened schedule on the
    fixture scene and its test PSNRs (``runs`` runs it in a child process,
    ``torch_parity.jax_child``)."""
    jargs = jconfig_parser(["--datadir", scene, "--expname", "fx",
                            "--basedir", basedir] + FLAGS)
    jcfg, jp, jmask, _ = jtrainer.reconstruction(jargs, log_fn=lambda *a: None)
    jds = jload_blender(scene, split="test", is_stack=True)
    return [float(p) for p in jevaluation(
        jds, jcfg, jp, jmask, None, N_vis=-1, white_bg=True,
        compute_extra_metrics=False, chunk=4096)]


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    """The shortened schedule through both packages' reconstruction, from
    one seed (their initial draws differ: a JAX key and a torch
    Generator), and the JAX run's test PSNRs. The JAX run goes on in a
    child process on two cores while the port's runs here."""
    base = tmp_path_factory.mktemp("runs")
    common = ["--datadir", scene, "--expname", "fx"] + FLAGS
    jax_psnr = jax_child("test_torch_train_loop:jax_reference_run", scene,
                         str(base / "jax"), cpus=2)
    targs = config_parser(common + ["--basedir", str(base / "port")])
    lines = []
    tcfg, tp, tmask, logfolder = ttrainer.reconstruction(
        targs, log_fn=lines.append, device="cpu")
    return {"jax_psnr": jax_psnr(), "port": (tcfg, tp, tmask), "logfolder":
            logfolder, "common": common, "base": base, "lines": lines}


def _psnr(scene, cfg, params, mask, **kw):
    ds = load_blender(scene, split="test", is_stack=True)
    return evaluation(ds, cfg, params, mask, None, N_vis=-1, white_bg=True,
                      device="cpu", **kw)


def test_reconstruction_matches_jax(scene, runs):
    """The port's run of the shortened schedule reaches the JAX run's mean
    test PSNR within 1 dB or better (30-33 dB on the fixture; the runs'
    random draws differ). The phases happened: a mask, a shrunk AABB, an
    upsampled grid, the ray filter logged, and the field saved in the
    format both packages load."""
    tcfg, tp, tmask = runs["port"]
    log = {}
    psnr = _psnr(scene, tcfg, tp, tmask, log=log)
    assert np.mean(psnr) >= np.mean(runs["jax_psnr"]) - 1.0, (
        psnr, runs["jax_psnr"])
    assert 0.5 < np.mean(log["ssim"]) <= 1.0
    assert tmask is not None and tmask.volume.shape == tcfg.grid_size[::-1]
    assert tcfg.aabb != ((-1.5,) * 3, (1.5,) * 3)
    assert any("Ray filtering done" in ln for ln in runs["lines"])
    path = os.path.join(runs["logfolder"], "fx.npz")
    jcfg2, jp2, jmask2 = jload_field(path)
    assert jcfg2.grid_size == tcfg.grid_size and jcfg2.aabb == tcfg.aabb
    np.testing.assert_array_equal(np.asarray(jmask2.volume),
                                  tmask.volume.numpy())
    for name, a in _flat(tp).items():
        np.testing.assert_array_equal(_flat(jp2)[name], a, err_msg=name)


def test_reconstruction_resumes_from_the_phase_checkpoint(scene, runs):
    """--ckpt <expname>_phase.npz --resume_iter <it of phase_ckpt.json>
    (the mask update at 140, after the shrink, the upsample and the ray
    filter) runs the last 60 iterations at the decayed rate and ends
    within 1 dB of the uninterrupted run's test PSNR."""
    logfolder = runs["logfolder"]
    with open(os.path.join(logfolder, "phase_ckpt.json")) as f:
        it = json.load(f)["it"]
    assert it == 140
    args = config_parser(runs["common"] + [
        "--basedir", str(runs["base"] / "resume"),
        "--ckpt", os.path.join(logfolder, "fx_phase.npz"),
        "--resume_iter", str(it)])
    lines = []
    cfg, p, mask, _ = ttrainer.reconstruction(args, log_fn=lines.append,
                                              device="cpu")
    assert any("resuming at it 00140" in ln or "resuming at it 140" in ln
               for ln in lines)
    full = np.mean(_psnr(scene, *runs["port"]))
    assert np.mean(_psnr(scene, cfg, p, mask)) >= full - 1.0


def test_train_cli_renders_a_checkpoint(scene, runs, tmp_path, capsys):
    """``train_cli --render_only 1 --render_test 1 --ckpt`` on the CPU: the
    test images, their depth composites and mean.txt next to the
    checkpoint, and the same PSNR as ``evaluation``; ``--export_mesh 1
    --ckpt`` writes the checkpoint's mesh beside it
    (``tests/test_torch_mesh.py`` holds the export to JAX's)."""
    ckpt = os.path.join(runs["logfolder"], "fx.npz")
    out = train_cli.main(["--datadir", scene, "--expname", "fx",
                          "--render_only", "1", "--render_test", "1",
                          "--ckpt", ckpt, "--device", "cpu"] + FLAGS)
    folder = os.path.join(runs["logfolder"], "imgs_test_all")
    assert sorted(os.listdir(folder))[:2] == ["000.png", "001.png"]
    assert os.path.exists(os.path.join(folder, "rgbd", "000.png"))
    with open(os.path.join(folder, "mean.txt")) as f:
        assert f.readline().startswith("PSNR:")
    cfg, p, mask = load_field(ckpt, device="cpu")
    assert out["test"] == pytest.approx(np.mean(_psnr(scene, cfg, p, mask)),
                                        abs=1e-9)
    assert "test all psnr" in capsys.readouterr().out
    # --export_mesh 1 alone writes <ckpt stem>.ply and neither renders nor
    # trains
    assert train_cli.main(["--export_mesh", "1", "--ckpt", ckpt,
                           "--device", "cpu"]) is None
    with open(ckpt[:-4] + ".ply", "rb") as f:
        header = f.read(400).split(b"end_header\n")[0].decode()
    n_faces = int(header.split("element face ")[1].split()[0])
    assert n_faces > 0 and "element vertex" in header
    assert "test all psnr" not in capsys.readouterr().out
    assert train_cli.main(["--datadir", scene, "--render_only", "1",
                           "--render_test", "1", "--ckpt",
                           str(tmp_path / "none.npz"), "--device",
                           "cpu"]) == {}
