"""Port parity for the object side of pose: isocell directions, the surface
sampler (one epoch with the JAX package's own draws handed to the port),
normals, ray colours, ``explore_field``, the per-frame evaluation
``test_pose_estimation``, the Blender and Tanks&Temples loaders and the
pose CLI (training, resuming, ``--config``, ``--backbone_ckpt``). The field
is made by the JAX package and reaches the port through ``load_field``."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from iffnerf_tpu.checkpoint import load_pytree, save_field, save_pytree
from iffnerf_tpu.data.blender import load_blender as jload_blender
from iffnerf_tpu.data.tankstemple import load_tankstemple as jload_tankstemple
from iffnerf_tpu.models import render as jrender
from iffnerf_tpu.models.field import make_alpha_mask as jmake_alpha_mask
from iffnerf_tpu.pose import isocell as jiso
from iffnerf_tpu.pose import sampling as jsamp
from iffnerf_tpu.pose.test import test_pose_estimation as jtest_pose_estimation
from iffnerf_tpu_torch import pose_cli
from iffnerf_tpu_torch.data.blender import load_blender as tload_blender
from iffnerf_tpu_torch.data.tankstemple import load_tankstemple as tload_tankstemple
from iffnerf_tpu_torch.models import field as tfield
from iffnerf_tpu_torch.models import render as trender
from iffnerf_tpu_torch.pose import id_module as tid
from iffnerf_tpu_torch.pose import isocell as tiso
from iffnerf_tpu_torch.pose import sampling as tsamp
from iffnerf_tpu_torch.pose import trainer as ttrainer
from iffnerf_tpu_torch.pose.test import test_pose_estimation as ttest_pose_estimation

from fixtures import make_blender_fixture
from torch_parity import (
    configs,
    field,
    near_mask_points,
    params,
    recorded_inerf,
    t,
    unit,
)

ROW_KEYS = {"sequence_id", "category_name", "frame_id", "loss", "scores_loss",
            "recall", "total_optimization_time_in_ms", "pred_c2w", "gt_c2w"}


@pytest.fixture(scope="module")
def vm(tmp_path_factory):
    return field(tmp_path_factory.mktemp("vm"), seed=5)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene") / "lego")
    return make_blender_fixture(root, n_train=2, n_test=2, wh=40, n_steps=64)


@pytest.fixture(scope="module")
def jax_rays(vm):
    """One candidate-ray set, made by the JAX package's explore_field."""
    (jcfg, jp, jmask), _ = vm
    rays = jsamp.explore_field(jax.random.PRNGKey(1), jcfg, jp, jmask,
                               gen_points=64, n_iteration=1,
                               max_resampling_iterations=10)
    return tuple(np.asarray(a) for a in rays)


# ---------------------------------------------------------------------------
# isocell
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("isrand", [-1, 0, 1, 2, 3, 4])
def test_isocell_distribution_is_bit_equal(isrand):
    want = jiso.isocell_distribution(27, N0=3, isrand=isrand,
                                     rng=np.random.default_rng(3))
    got = tiso.isocell_distribution(27, N0=3, isrand=isrand,
                                    rng=np.random.default_rng(3))
    assert got.shape == (27, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_rotate_isocell_matches():
    """Random normals plus the poles: +z (the antiparallel guard) and -z."""
    dirs = jiso.isocell_distribution(27, N0=3, isrand=-1)
    rng = np.random.default_rng(4)
    normals = np.concatenate([rng.standard_normal((61, 3)),
                              [[0, 0, 1], [0, 0, -1], [1e-7, 0, 1]]])
    normals = unit(normals)
    want = np.asarray(jiso.rotate_isocell(jnp.asarray(dirs), jnp.asarray(normals)))
    got = tiso.rotate_isocell(t(dirs), t(normals)).numpy()
    assert got.shape == (64, 27, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the sampler, with the JAX package's draws
# ---------------------------------------------------------------------------


def test_sampling_epoch_step_matches_with_jax_draws(vm):
    """JAX _sampling_epoch at max_iterations=1 against the port's one step,
    fed the draws the JAX loop body makes from the same key."""
    (jcfg, jp, jmask), (tcfg, tp, tmask) = vm
    n = 300
    samples = near_mask_points(jmask.volume, jcfg.aabb_np, n, 6, spread=0.2)
    alpha = jrender.compute_alpha(jcfg, jp, jmask, jnp.asarray(samples), 1.0)
    rho = jnp.float32(0.3)
    key = jax.random.PRNGKey(7)
    s_j, a_j, it, n_invalid = jsamp._sampling_epoch(
        jcfg, jp, jmask, True, jnp.asarray(samples), alpha, rho, key,
        max_iterations=1)
    assert int(it) == 1

    # the loop body's draws (sampling.py:111-121)
    _, jit_key, sel_key = jax.random.split(key, 3)
    jitter = jsamp._sphere_jitter(jit_key, (n, 5), rho)
    u = jax.random.uniform(sel_key, (n, 5))

    alpha_t = t(alpha)
    thresh = torch.quantile(alpha_t, 0.6)
    np.testing.assert_allclose(float(thresh), float(jnp.quantile(alpha, 0.6)),
                               rtol=1e-6)
    s_t, a_t, invalid_t = tsamp.sampling_step(
        tcfg, tp, tmask, t(samples), alpha_t,
        torch.ones(n, dtype=torch.bool), thresh, t(jitter), t(u))

    accepted_j = np.any(np.asarray(s_j) != samples, axis=-1)
    np.testing.assert_array_equal(~invalid_t.numpy(), accepted_j)
    assert int(n_invalid) == int(invalid_t.sum())
    assert 0 < accepted_j.sum() < n
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=1e-6, rtol=0)


def test_sphere_jitter_statistics():
    """The port's own draws: |N(0, rho)| radii along uniform directions."""
    gen = torch.Generator().manual_seed(0)
    j = tsamp.sphere_jitter(gen, (20000, 5), 0.3, torch.device("cpu")).numpy()
    r = np.linalg.norm(j, axis=-1)
    # E|N(0, rho)| = rho * sqrt(2 / pi); a uniform direction averages to 0
    assert abs(r.mean() - 0.3 * np.sqrt(2 / np.pi)) < 0.005
    assert np.abs((j / r[..., None]).mean(axis=(0, 1))).max() < 0.01


@pytest.mark.parametrize("empty", [False, True])
def test_occupancy_samples_match_with_jax_draws(vm, empty):
    """generate_samples_from_occupancy_grid against the port's inverse-CDF
    step fed the same randint and jitter draws; an all-empty mask clamps
    every pick to the last voxel (tests/test_pose_pipeline.py)."""
    (jcfg, _, jmask), (_, _, tmask) = vm
    if empty:
        aabb = np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)
        jmask = jmake_alpha_mask(jnp.zeros((8, 9, 10)), aabb)
        tmask = tfield.make_alpha_mask(torch.zeros((8, 9, 10)), aabb)
    n = 257
    key = jax.random.PRNGKey(8)
    want = np.asarray(jsamp.generate_samples_from_occupancy_grid(key, jmask, n))
    k1, k2 = jax.random.split(key)
    total = max(int((np.asarray(jmask.volume) > 0).sum()), 1)
    u = jax.random.randint(k1, (n,), 0, total)
    jitter = jax.random.uniform(k2, (n, 3))
    got = tsamp.samples_from_occupancy(tmask, t(u), t(jitter)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if empty:
        voxel = 3.0 / (np.array([10, 9, 8]) - 1.0)
        assert np.all(got >= 1.5 - 1e-5) and np.all(got <= 1.5 + voxel + 1e-5)


# ---------------------------------------------------------------------------
# normals, ray colours, explore_field
# ---------------------------------------------------------------------------


def test_normals_and_ray_colours_match(vm):
    """samples_points_normals, evaluate_viewdirs_color and
    generate_all_possible_rays (ragged colour chunks) on the same points."""
    (jcfg, jp, jmask), (tcfg, tp, tmask) = vm
    pts = near_mask_points(jmask.volume, jcfg.aabb_np, 64, 9, spread=0.05)
    want_n = np.asarray(jsamp.samples_points_normals(jcfg, jp, jnp.asarray(pts)))
    got_n = tsamp.samples_points_normals(tcfg, tp, t(pts)).numpy()
    np.testing.assert_allclose(got_n, want_n, atol=1e-5, rtol=1e-5)

    dirs = unit(np.random.default_rng(10).standard_normal((64, 27, 3)))
    pts_b = np.broadcast_to(pts[:, None], dirs.shape).copy()
    want_c = np.asarray(jsamp.evaluate_viewdirs_color(
        jcfg, jp, jmask, jnp.asarray(pts_b), jnp.asarray(dirs)))
    got_c = tsamp.evaluate_viewdirs_color(tcfg, tp, tmask, t(pts_b),
                                          t(dirs)).numpy()
    # exp and cumprod along the ray in another order (test_torch_field.py)
    np.testing.assert_allclose(got_c, want_c, atol=1e-5, rtol=1e-5)
    assert np.ptp(got_c) > 0.01, "the rays must see the field"

    chunk = 27 * 10  # 10 points a chunk: 7 chunks, the last ragged
    want = jsamp.generate_all_possible_rays(
        jcfg, jp, jmask, jnp.asarray(pts), jnp.asarray(want_n),
        num_viewdirs_per_chunk=chunk)
    got = tsamp.generate_all_possible_rays(
        tcfg, tp, tmask, t(pts), t(want_n), num_viewdirs_per_chunk=chunk)
    for name, g, w in zip(("ori", "dirs", "rgb"), got, want):
        assert g.shape == (64 * 27, 3), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_explore_field_statistics(vm):
    """The port's own draws: 64 points x 27 isocell directions, unit
    directions, colours in [0, 1], samples in the AABB (up to the in-voxel
    jitter's one voxel) and denser than uniform points."""
    (jcfg, _, _), (tcfg, tp, tmask) = vm
    gen = torch.Generator().manual_seed(0)
    ori, dirs, rgb = tsamp.explore_field(
        gen, tcfg, tp, tmask, gen_points=64, n_iteration=1,
        max_resampling_iterations=10, device="cpu")
    for a in (ori, dirs, rgb):
        assert a.shape == (64 * 27, 3) and torch.isfinite(a).all()
    np.testing.assert_allclose(torch.linalg.norm(dirs, dim=-1).numpy(), 1.0,
                               atol=1e-4)
    assert rgb.min() >= 0.0 and rgb.max() <= 1.0
    voxel = float(np.max(tcfg.units))
    aabb = tcfg.aabb_np
    pts = ori[::27]
    assert torch.equal(ori.reshape(64, 27, 3), pts[:, None].expand(64, 27, 3))
    assert (pts.numpy() >= aabb[0] - voxel).all()
    assert (pts.numpy() <= aabb[1] + voxel).all()
    uniform = tsamp.generate_uniform_samples(torch.Generator().manual_seed(1),
                                             tcfg, 2000, torch.device("cpu"))
    a_s = trender.compute_alpha(tcfg, tp, tmask, pts, 1.0)
    a_u = trender.compute_alpha(tcfg, tp, tmask, uniform, 1.0)
    assert a_s.median() > a_u.median()

    samples, epochs = tsamp.iterative_surface_sampling_process(
        torch.Generator().manual_seed(2), tcfg, tp, tmask, gen_points=32,
        n_iteration=2, max_resampling_iterations=10, device="cpu")
    assert samples.shape == (32, 3) and len(epochs) == 2
    for it, n_invalid in epochs:
        assert 1 <= it <= 10 and 0 <= n_invalid <= 32
        assert it == 10 or n_invalid == 0


# ---------------------------------------------------------------------------
# the evaluation harness, the loader and the CLI
# ---------------------------------------------------------------------------


def test_blender_loader_matches(scene):
    for split in ("train", "test"):
        want = jload_blender(scene, split=split, is_stack=True)
        got = tload_blender(scene, split=split, is_stack=True)
        for name in ("all_rays", "all_rgbs", "poses", "K", "scene_bbox",
                     "directions"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name), err_msg=name)
        assert (got.img_wh, got.near_far, got.white_bg) == (
            want.img_wh, want.near_far, want.white_bg)


def test_pose_estimation_harness_matches(scene, jax_rays, tmp_path):
    """test_pose_estimation on 2 frames, float32, depth-1 ViT, the same
    rays: poses to 1e-4, equal recall, score loss to 1e-4, the same row
    keys and the same debug-dump fields."""
    jcfg, tcfg = configs(depth=1)
    jp, tp = params(12, jcfg)
    ds_j = jload_blender(scene, split="test", is_stack=True)
    ds_t = tload_blender(scene, split="test", is_stack=True)
    up = np.asarray(ds_j.poses)[:, :3, 1].mean(axis=0)
    quiet = dict(log_fn=lambda *a: None, save=True, save_all=True)
    want, *want_avg = jtest_pose_estimation(
        ds_j, jp, jcfg, *(jnp.asarray(a) for a in jax_rays), jnp.asarray(up),
        sequence_id="lego", save_dir=str(tmp_path / "jax"), **quiet)
    got, *got_avg = ttest_pose_estimation(
        ds_t, tp, tcfg, *jax_rays, up, sequence_id="lego",
        save_dir=str(tmp_path / "port"), device="cpu", **quiet)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w) == ROW_KEYS
        assert g["recall"] == w["recall"]
        np.testing.assert_allclose(g["scores_loss"], w["scores_loss"], rtol=1e-4)
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        np.testing.assert_allclose(g["pred_c2w"], w["pred_c2w"], atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_array_equal(g["gt_c2w"], w["gt_c2w"])
        assert (g["frame_id"], g["sequence_id"], g["category_name"]) == (
            w["frame_id"], w["sequence_id"], w["category_name"])
        assert g["total_optimization_time_in_ms"] > 0
    np.testing.assert_allclose(got_avg, want_avg, rtol=1e-4, atol=1e-6)
    for i in range(2):
        with np.load(tmp_path / "jax" / f"sample_results_{i}.npz") as dj, \
                np.load(tmp_path / "port" / f"sample_results_{i}.npz") as dt:
            assert sorted(dt.files) == sorted(dj.files)
            np.testing.assert_allclose(dt["pred_c2w_matrix"],
                                       dj["pred_c2w_matrix"], atol=1e-4)
            np.testing.assert_array_equal(np.sort(dt["topk_unique_ray_idx"]),
                                          np.sort(dj["topk_unique_ray_idx"]))


def test_pose_estimation_runs_the_inerf_refinement(scene, vm, jax_rays,
                                                   monkeypatch):
    """With inerf_refinement and nerf, each frame's banked estimate goes to
    estimate_pose_inerf with the JAX package's arguments (pose/test.py:
    228-240: RGB with the mask as alpha, K[0], 800 iterations, lrate 0.02,
    dice loss, random pixels, the default seed), here cut to 2 iterations,
    and the refined pose replaces the estimate before the errors are
    taken."""
    calls = recorded_inerf(monkeypatch)
    jcfg, tcfg = configs(depth=1)
    _, tp = params(12, jcfg)
    ds = tload_blender(scene, split="test", is_stack=True)
    up = np.asarray(ds.poses)[:, :3, 1].mean(axis=0)
    nerf = vm[1]
    plain, *_ = ttest_pose_estimation(ds, tp, tcfg, *jax_rays, up,
                                      log_fn=lambda *a: None, device="cpu")
    rows, t_err, a_err, _, _ = ttest_pose_estimation(
        ds, tp, tcfg, *jax_rays, up, inerf_refinement=True, nerf=nerf,
        log_fn=lambda *a: None, device="cpu")
    assert len(calls) == len(rows) == 2
    w, h = ds.img_wh
    for i, ((args, kw, out), row, base) in enumerate(zip(calls, rows, plain)):
        start, obs4, cam_k, config, fparams, fmask = args
        assert kw == dict(n_iters=800, lrate=0.02, dice_loss=True,
                          sampling_strategy="random",
                          device=torch.device("cpu"))
        np.testing.assert_allclose(np.asarray(start), base["pred_c2w"],
                                   atol=1e-6)
        rgba = np.asarray(ds.all_rgbs[i], np.float32).reshape(h, w, 4)
        alpha = rgba[..., 3:]
        np.testing.assert_allclose(
            obs4.numpy(), np.concatenate(
                [rgba[..., :3] * alpha + (1 - alpha), alpha], -1), atol=1e-6)
        np.testing.assert_array_equal(cam_k, np.asarray(ds.K[0]))
        assert (config, fparams, fmask) == (nerf[0], nerf[1], nerf[2])
        np.testing.assert_array_equal(row["pred_c2w"], out[1])
    gt = [np.asarray(r["gt_c2w"]) for r in rows]
    want_t = np.mean([np.linalg.norm(g[:3, 3] - c[1][:3, 3])
                      for g, c in zip(gt, [c[2] for c in calls])])
    np.testing.assert_allclose(t_err, want_t, rtol=1e-5)
    assert np.isfinite(a_err)


def _count_steps(monkeypatch):
    """Counts the trainer's optimizer steps (the loop looks the step up in
    its module at each iteration)."""
    steps = []
    step = ttrainer.id_train_step

    def counted(*a, **kw):
        steps.append(1)
        return step(*a, **kw)

    monkeypatch.setattr(ttrainer, "id_train_step", counted)
    return steps


def _check_rows(rows, sequence_id, n):
    assert len(rows) == n
    for i, row in enumerate(rows):
        assert set(row) == ROW_KEYS
        assert (row["sequence_id"], row["frame_id"]) == (sequence_id, i)
        assert np.isfinite(row["pred_c2w"]).all()
        assert np.asarray(row["pred_c2w"]).shape == (4, 4)
        assert 0.0 <= row["recall"] <= 1.0


def test_pose_cli_on_the_fixture(scene, vm, tmp_path, monkeypatch):
    """The pose CLI over one tensorf_<obj>_VM run with a field checkpoint
    written by the JAX package. Without an id_module.npz it trains one
    (two steps of two images), saves it with epoch 2 where the JAX package
    loads it, and writes the rows; a second run resumes from it at epoch 2
    and takes no step."""
    monkeypatch.chdir(tmp_path)  # the trainer writes runs/
    steps = _count_steps(monkeypatch)
    run = tmp_path / "log" / "tensorf_lego_VM"
    run.mkdir(parents=True)
    save_field(str(run / "tensorf_lego_VM.npz"), *vm[0])
    argv = ["--datadir", os.path.dirname(scene), "--exp_patch",
            str(tmp_path / "log"), "--out_path", str(tmp_path / "out.json"),
            "--gen_points", "32", "--id_backbone_depth", "1",
            "--id_iters", "2", "--accum_steps", "2", "--device", "cpu"]
    pose_cli.main(argv + ["--save_debug", "1"])
    assert len(steps) == 2
    trained, meta = load_pytree(str(run / "id_module.npz"))
    assert meta == {"epoch": 2}
    jcfg, _ = configs(depth=1)
    assert jax.tree.structure(trained) == jax.tree.structure(
        params(13, jcfg)[0])
    with open(tmp_path / "out.json") as fh:
        _check_rows(json.load(fh), "lego", 2)
    assert (tmp_path / "sample_results_0.npz").exists()
    assert not (tmp_path / "sample_results_1.npz").exists()

    rows = pose_cli.main(argv)
    assert len(steps) == 2
    _check_rows(rows, "lego", 2)
    resumed, meta = load_pytree(str(run / "id_module.npz"))
    assert meta == {"epoch": 2}
    for a, b in zip(jax.tree.leaves(resumed), jax.tree.leaves(trained)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pose_cli_backbone_ckpt(scene, vm, tmp_path, monkeypatch):
    """--backbone_ckpt replaces the initial backbone: with --id_iters 0 the
    saved id_module.npz holds that file's backbone and the --seed's other
    parameters."""
    monkeypatch.chdir(tmp_path)
    run = tmp_path / "log" / "tensorf_lego_VM"
    run.mkdir(parents=True)
    save_field(str(run / "tensorf_lego_VM.npz"), *vm[0])
    jcfg, _ = configs(depth=1)
    backbone = jax.tree.map(np.asarray, params(14, jcfg)[0]["backbone"])
    save_pytree(str(tmp_path / "dinov2.npz"), backbone)
    pose_cli.main(["--datadir", scene, "--exp_patch", str(tmp_path / "log"),
                   "--out_path", str(tmp_path / "out.json"),
                   "--gen_points", "32", "--id_backbone_depth", "1",
                   "--id_iters", "0", "--backbone_ckpt",
                   str(tmp_path / "dinov2.npz"), "--seed", "3",
                   "--device", "cpu"])
    saved, meta = load_pytree(str(run / "id_module.npz"))
    assert meta == {"epoch": 0}
    for a, b in zip(jax.tree.leaves(saved["backbone"]),
                    jax.tree.leaves(backbone)):
        np.testing.assert_array_equal(np.asarray(a), b)
    _, tcfg = configs(depth=1)
    init = tid.init_id_module(torch.Generator().manual_seed(3), tcfg,
                              device="cpu")
    np.testing.assert_array_equal(np.asarray(saved["q_proj"]["w"]),
                                  init["q_proj"]["w"].numpy())
    with open(tmp_path / "out.json") as fh:
        _check_rows(json.load(fh), "lego", 2)


TT_INTRINSICS = np.array([[1100.0, 0, 960, 0], [0, 1100.0, 540, 0],
                          [0, 0, 1, 0], [0, 0, 0, 1]])


def make_tankstemple_fixture(root, wh=(48, 27), n=(2, 1, 2), seed=0):
    """A Tanks&Temples (NSVF layout) micro-scene: intrinsics.txt for
    1920x1080, bbox.txt, pose/ and rgb/ with 0_ train, 1_ val and 2_ test
    frames; RGB PNGs of a coloured disc on white (the loader synthesizes
    the mask from the distance to white), cameras on a sphere of radius 4
    looking at the origin (OpenCV convention)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "pose"))
    os.makedirs(os.path.join(root, "rgb"))
    np.savetxt(os.path.join(root, "intrinsics.txt"), TT_INTRINSICS)
    np.savetxt(os.path.join(root, "bbox.txt"),
               [[-1.0, -1.0, -1.0, 1.0, 1.0, 1.0, 0.1]])
    w, h = wh
    yy, xx = np.mgrid[0:h, 0:w]
    for prefix, count in zip(("0_", "1_", "2_"), n):
        for k in range(count):
            theta = rng.uniform(0, 2 * np.pi)
            campos = 4.0 * np.array([np.cos(theta) * 0.8, np.sin(theta) * 0.8,
                                     0.6])
            z = -campos / np.linalg.norm(campos)
            x = np.cross(z, [0.0, 0.0, -1.0])
            x /= np.linalg.norm(x)
            c2w = np.eye(4)
            c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = x, np.cross(z, x), z
            c2w[:3, 3] = campos
            name = f"{prefix}{k:04d}"
            np.savetxt(os.path.join(root, "pose", f"{name}.txt"), c2w)
            disc = (yy - h / 2) ** 2 + (xx - w / 2) ** 2 < (h / 3) ** 2
            img = np.full((h, w, 3), 255, np.uint8)
            img[disc] = rng.integers(0, 200, 3)
            Image.fromarray(img, "RGB").save(
                os.path.join(root, "rgb", f"{name}.png"))
    return root


@pytest.fixture(scope="module")
def tt_scene(tmp_path_factory):
    return make_tankstemple_fixture(str(tmp_path_factory.mktemp("tt") / "truck"))


@pytest.mark.parametrize("downsample", [40.0, 20.0])
def test_tankstemple_loader_matches(tt_scene, downsample):
    """Every split, at the images' own size (1920x1080 / 40) and resized
    up by LANCZOS (/ 20)."""
    for split in ("train", "val", "test"):
        want = jload_tankstemple(tt_scene, split=split, downsample=downsample,
                                 is_stack=True)
        got = tload_tankstemple(tt_scene, split=split, downsample=downsample,
                                is_stack=True)
        for name in ("all_rays", "all_rgbs", "poses", "K", "scene_bbox",
                     "directions", "render_path"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name), err_msg=name)
        assert (got.img_wh, got.near_far, got.white_bg) == (
            want.img_wh, want.near_far, want.white_bg)
    assert got.all_rgbs.shape[-1] == 4 and 0 < got.all_rgbs[..., 3].mean() < 1


def test_pose_cli_reads_config_and_tankstemple(tt_scene, vm, tmp_path,
                                               monkeypatch):
    """Flags from a --config file (CLI flags over it), and a Tanks&Temples
    run: a tensorf_<obj>_VMtt dir read with the tankstemple loader."""
    monkeypatch.chdir(tmp_path)
    steps = _count_steps(monkeypatch)
    run = tmp_path / "log" / "tensorf_truck_VMtt"
    run.mkdir(parents=True)
    save_field(str(run / "tensorf_truck_VMtt.npz"), *vm[0])
    cfg = tmp_path / "truck.txt"
    cfg.write_text("# a small pose config\n"
                   "dataset_name = tankstemple\n"
                   "downsample_train = 40\n"
                   "gen_points = 500  # overridden on the command line\n"
                   "id_backbone_depth = 1\n"
                   "id_iters = 1\n"
                   "accum_steps = 2\n"
                   "device = cpu\n")
    argv = ["--config", str(cfg), "--datadir", os.path.dirname(tt_scene),
            "--exp_patch", str(tmp_path / "log"), "--out_path",
            str(tmp_path / "out.json"), "--gen_points", "32"]
    args = pose_cli.parse_args(argv)
    assert (args.dataset_name, args.downsample_train, args.gen_points,
            args.id_iters, args.accum_steps, args.device) == (
        "tankstemple", 40.0, 32, 1, 2, "cpu")
    rows = pose_cli.main(argv)
    assert len(steps) == 1
    _check_rows(rows, "truck", 2)
    _, meta = load_pytree(str(run / "id_module.npz"))
    assert meta == {"epoch": 1}


@pytest.mark.parametrize("name", sorted(
    os.listdir(os.path.join(os.path.dirname(__file__), "..", "configs"))))
def test_config_parser_matches_jax(name):
    """The copied flag system reads every config file of the repo, with a
    flag over it, as the JAX package's does."""
    from iffnerf_tpu.config import config_parser as jconfig_parser
    from iffnerf_tpu_torch.config import config_parser as tconfig_parser

    path = os.path.join(os.path.dirname(__file__), "..", "configs", name)
    cmd = ["--config", path, "--n_iters", "7"]
    want = vars(jconfig_parser(cmd))
    got = vars(tconfig_parser(cmd))
    assert got == want and got["n_iters"] == 7


def test_pose_cli_goes_on_past_a_failing_object(scene, vm, tmp_path,
                                                monkeypatch):
    """A RuntimeError in one object's evaluation (here its field fails to
    load) prints its traceback and leaves the other objects' rows in
    --out_path, as train_eval_pose_est.py's per-object guard does."""
    jcfg, _ = configs(depth=1)
    jp, _ = params(13, jcfg)
    for obj in ("lego", "ship"):
        run = tmp_path / "log" / f"tensorf_{obj}_VM"
        run.mkdir(parents=True)
        save_field(str(run / f"tensorf_{obj}_VM.npz"), *vm[0])
        save_pytree(str(run / "id_module.npz"),
                    jax.tree_util.tree_map(np.asarray, jp), {"epoch": 1})
    load_model = pose_cli.load_model

    def load_or_fail(path, **kw):
        if "ship" in os.path.basename(path):
            raise RuntimeError("a checkpoint that does not load")
        return load_model(path, **kw)

    monkeypatch.setattr(pose_cli, "load_model", load_or_fail)
    monkeypatch.chdir(tmp_path)  # the trainer writes runs/
    # no <datadir>/<obj> folder: both objects read the one fixture scene;
    # --id_iters 1 resumes at the id_module.npz's epoch, with no step
    rows = pose_cli.main(["--datadir", scene, "--exp_patch",
                          str(tmp_path / "log"), "--out_path",
                          str(tmp_path / "out.json"), "--gen_points", "32",
                          "--id_backbone_depth", "1", "--id_iters", "1",
                          "--device", "cpu"])
    with open(tmp_path / "out.json") as fh:
        saved = json.load(fh)
    assert saved == rows and len(saved) == 2
    assert {row["sequence_id"] for row in saved} == {"lego"}
