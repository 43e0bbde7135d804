"""Port parity for the host tools under ``iffnerf_tpu_torch/tools/``
against the JAX package's ``tools/`` and ``extra/``: the histogram study,
``colmap2nerf``, ``compute_scaling_factor``, ``compute_metrics``, the
accuracy gate (its checks, and one chain through the port's pose CLI on
the CPU), ``auto_run_paramsets`` and the launch scripts. Every tolerance
is stated beside its test."""

import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from iffnerf_tpu_torch.tools import auto_run_paramsets as tsweep
from iffnerf_tpu_torch.tools import colmap2nerf as tcolmap
from iffnerf_tpu_torch.tools import compute_metrics as tmetrics
from iffnerf_tpu_torch.tools import compute_scaling_factor as tcsf
from iffnerf_tpu_torch.tools import gen_fixture_scene as tgen
from iffnerf_tpu_torch.tools import histogram_correlation as thist
from iffnerf_tpu_torch.tools import run_accuracy_gate as tgate

from fixtures import make_blender_fixture
from torch_parity import field

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "iffnerf_tpu_torch", "tools")


def _jax_script(rel):
    """A script of the JAX package's tools/ or extra/, loaded by path."""
    name = "jax_" + os.path.basename(rel)[:-3]
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("comparison", ["pearson", "spearman", "chi_squared",
                                        "L2", "kl_divergence"])
def test_histogram_study_equals_jax(comparison):
    """build_hist and pairwise_coefficients equal the JAX package's tool bit
    for bit (tests/test_tools.py's inputs: images with ties for Spearman's
    ranks, random rows), and an unknown metric raises in both."""
    jhist = _jax_script("tools/histogram_correlation.py")
    rng = np.random.default_rng(1)
    imgs = rng.random((3, 8, 8, 3)).astype(np.float32)
    imgs[1, :4] = 0.5
    np.testing.assert_array_equal(thist.build_hist(imgs),
                                  jhist.build_hist(imgs))
    hists = thist.build_hist(imgs)
    a, b = rng.random((4, 50)), rng.random((3, 50))
    for x, y in ((a, b), (hists, hists[:2])):
        np.testing.assert_array_equal(
            thist.pairwise_coefficients(x, y, comparison),
            jhist.pairwise_coefficients(x, y, comparison))
    with pytest.raises(ValueError):
        thist.pairwise_coefficients(a, b, "nope")


def test_histogram_correlation_on_the_fixture(tmp_path):
    """compute_correlation over the fixture scene through the port's
    load_blender: the JAX tool's distances and coefficients within 1e-6,
    the same CSV rows."""
    jhist = _jax_script("tools/histogram_correlation.py")
    scene = make_blender_fixture(str(tmp_path / "scene"), n_train=3,
                                 n_test=2, wh=16, n_steps=32)
    got = thist.main([scene, "--out_csv", str(tmp_path / "t.csv")])
    want = jhist.compute_correlation(scene, out_csv=str(tmp_path / "j.csv"))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    assert (tmp_path / "t.csv").read_text().splitlines()[0] == \
        (tmp_path / "j.csv").read_text().splitlines()[0]


def _colmap_text_model(model):
    """tests/test_tools_more.py's text model, and a third camera turned."""
    os.makedirs(model)
    (model / "cameras.txt").write_text(
        "# cams\n1 PINHOLE 64 48 80.0 80.0 32.0 24.0\n")
    (model / "images.txt").write_text(
        "1 1 0 0 0 0 0 2 1 r_0.png\n\n"
        "2 1 0 0 0 0 0 4 1 r_1.png\n\n"
        "3 0.9238795 0.3826834 0 0 0.5 -1 3 1 r_2.png\n\n")


def test_colmap2nerf_matches_jax(tmp_path, monkeypatch):
    """The port's colmap2nerf writes the JAX tool's transforms.json on a
    COLMAP text model: the same keys and frame names, every number within
    1e-6."""
    jcolmap = _jax_script("tools/colmap2nerf.py")
    model = tmp_path / "sparse0"
    _colmap_text_model(model)
    tcolmap.main(["--colmap_dir", str(model), "--out",
                  str(tmp_path / "t.json")])
    monkeypatch.setattr(sys, "argv", ["colmap2nerf", "--colmap_dir",
                                      str(model), "--out",
                                      str(tmp_path / "j.json")])
    jcolmap.main()
    got = json.loads((tmp_path / "t.json").read_text())
    want = json.loads((tmp_path / "j.json").read_text())
    assert got.keys() == want.keys() and len(got["frames"]) == 3
    for key, w in want.items():
        if key != "frames":
            np.testing.assert_allclose(got[key], w, rtol=1e-6, err_msg=key)
    for g, w in zip(got["frames"], want["frames"]):
        assert g["file_path"] == w["file_path"]
        np.testing.assert_allclose(g["transform_matrix"],
                                   w["transform_matrix"], atol=1e-6)


def _ratios(text):
    return [json.loads(m) for m in re.findall(r"ratio (\[[^\]]*\])", text)]


def test_compute_scaling_factor_matches_jax(tmp_path, monkeypatch, capsys):
    """The port's tool (--device cpu) prints the JAX tool's line for the
    field the JAX package wrote (tests/test_tools_more.py's set-up, its
    AABB shrunk so the ratio is not 1): the ratio within 1e-5."""
    import jax

    from iffnerf_tpu.checkpoint import save_field
    from iffnerf_tpu.models import FieldConfig, init_field

    jcsf = _jax_script("tools/compute_scaling_factor.py")
    scene = make_blender_fixture(str(tmp_path / "scene"), n_train=2,
                                 n_test=1, wh=16, n_steps=32)
    expdir = tmp_path / "log" / "tensorf_obj_VM"
    os.makedirs(expdir)
    cfg = FieldConfig(grid_size=(8, 8, 8), density_n_comp=(2, 2, 2),
                      app_n_comp=(2, 2, 2), app_dim=3,
                      shading_mode="MLP_Fea", feature_c=8, view_pe=2,
                      fea_pe=2, aabb=((-1.2, -1.0, -0.7), (1.1, 1.3, 0.9)))
    save_field(str(expdir / "ckpt.npz"), cfg,
               init_field(jax.random.PRNGKey(0), cfg))
    argv = ["--exp_patch", str(tmp_path / "log"), "--datadir", scene,
            "--data_type", "blender"]
    tcsf.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["compute_scaling_factor", *argv])
    jcsf.main()
    want = capsys.readouterr().out
    assert "obj" in got and len(_ratios(got)) == 1
    np.testing.assert_allclose(_ratios(got), _ratios(want), rtol=1e-5)
    assert not np.allclose(_ratios(got), 1.0)


def test_compute_metrics_matches_jax(tmp_path, capsys):
    """PSNR and SSIM of two directories of PNGs (renders with noise
    against their ground truth) within 1e-5 of the JAX package's metric
    functions on the same images, and the JAX script's printed lines."""
    from PIL import Image

    from iffnerf_tpu.utils.metrics import mse2psnr, rgb_ssim

    jmetrics = _jax_script("extra/compute_metrics.py")
    rng = np.random.default_rng(0)
    a, b = tmp_path / "renders", tmp_path / "gt"
    os.makedirs(a)
    os.makedirs(b)
    for i in range(2):
        gt = rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
        noisy = np.clip(gt + rng.integers(-20, 20, gt.shape), 0, 255)
        Image.fromarray(noisy.astype(np.uint8)).save(a / f"{i}.png")
        Image.fromarray(gt).save(b / f"{i}.png")
    got = tmetrics.main(str(a), str(b))
    printed = capsys.readouterr().out
    pairs = list(zip(jmetrics.load_dir(str(a)), jmetrics.load_dir(str(b))))
    want_psnr = np.mean([mse2psnr(float(np.mean((r - g) ** 2)))
                         for r, g in pairs])
    want_ssim = np.mean([float(rgb_ssim(r, g, 1.0)) for r, g in pairs])
    np.testing.assert_allclose(got["psnr"], want_psnr, rtol=1e-5)
    np.testing.assert_allclose(got["ssim"], want_ssim, rtol=1e-5)
    assert got["ssim"] < 0.99
    jmetrics.main(str(a), str(b))
    assert printed == capsys.readouterr().out


def test_apply_gate_logic():
    """tests/test_accuracy_gate.py's cases: a pass, a rotation over its
    bound, an accuracy under its bound."""

    class A:
        max_median_rot_deg = 10.0
        max_median_trans = 0.2
        min_acc5 = 50.0

    good = {"median_angular_error": 5.0, "median_translation_error": 0.1,
            "ang_acc@5.": 80.0}
    bad = dict(good, median_angular_error=12.0)
    low_acc = dict(good, **{"ang_acc@5.": 20.0})
    assert tgate.apply_gate(dict(good), A()) is True
    assert tgate.apply_gate(dict(bad), A()) is False
    assert tgate.apply_gate(dict(low_acc), A()) is False


def test_evaluate_poses_equals_jax(tmp_path):
    """The gate's copy of evaluate_poses gives the JAX package's
    tools/compute_eval_statistics.py statistics on the same rows."""
    from tools.compute_eval_statistics import evaluate_poses

    rng = np.random.default_rng(3)
    rows = []
    for i in range(5):
        pred = np.eye(4)
        c, s = np.cos(0.1 * i), np.sin(0.1 * i)
        pred[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        pred[:3, 3] = rng.normal(0, 0.2, 3)
        rows.append({"gt_c2w": np.eye(4).tolist(), "pred_c2w": pred.tolist(),
                     "total_optimization_time_in_ms": 10.0 + i,
                     "loss": 0.01 * i})
    path = tmp_path / "rows.json"
    path.write_text(json.dumps(rows))
    got, want = tgate.evaluate_poses(str(path)), evaluate_poses(str(path))
    assert got.keys() == want.keys()
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=1e-12, err_msg=key)


def test_gate_converts_a_torch_checkpoint(tmp_path):
    """The gate's step 1: a torch-hub DINOv2 checkpoint (random weights of
    one block in its naming) goes through the port's converter in a child
    process into an npz that loads with the checkpoint's arrays; an
    existing npz is taken as it is, a missing one raises."""
    import torch

    from iffnerf_tpu_torch.checkpoint import load_pytree
    from iffnerf_tpu_torch.pose.vit import ViTConfig

    cfg = ViTConfig(depth=1)
    d, h = cfg.dim, cfg.dim * cfg.mlp_ratio
    rng = np.random.default_rng(0)
    shapes = {"patch_embed.proj.weight": (d, 3, cfg.patch_size,
                                          cfg.patch_size),
              "patch_embed.proj.bias": (d,), "cls_token": (1, 1, d),
              "pos_embed": (1, 1 + cfg.n_patches, d), "norm.weight": (d,),
              "norm.bias": (d,), "blocks.0.norm1.weight": (d,),
              "blocks.0.norm1.bias": (d,), "blocks.0.attn.qkv.weight":
              (3 * d, d), "blocks.0.attn.qkv.bias": (3 * d,),
              "blocks.0.attn.proj.weight": (d, d),
              "blocks.0.attn.proj.bias": (d,), "blocks.0.ls1.gamma": (d,),
              "blocks.0.norm2.weight": (d,), "blocks.0.norm2.bias": (d,),
              "blocks.0.mlp.fc1.weight": (h, d), "blocks.0.mlp.fc1.bias":
              (h,), "blocks.0.mlp.fc2.weight": (d, h),
              "blocks.0.mlp.fc2.bias": (d,), "blocks.0.ls2.gamma": (d,)}
    sd = {k: torch.from_numpy(rng.standard_normal(v).astype(np.float32))
          for k, v in shapes.items()}
    torch.save(sd, tmp_path / "dinov2.pth")
    out = tgate.convert_weights(str(tmp_path / "dinov2.pth"), str(tmp_path))
    params, meta = load_pytree(out, device="cpu")
    assert meta == {"arch": "dinov2_vits14"}
    np.testing.assert_array_equal(params["blocks"][0]["qkv"]["b"].numpy(),
                                  sd["blocks.0.attn.qkv.bias"].numpy())
    assert tgate.convert_weights(out, str(tmp_path)) == out
    with pytest.raises(FileNotFoundError):
        tgate.convert_weights(str(tmp_path / "missing.npz"), str(tmp_path))


@pytest.fixture(scope="module")
def gate_setup(tmp_path_factory):
    """The fixture scene and a field written by the JAX package, laid out
    as the pose CLI reads it (a run dir named tensorf_<obj>_VM)."""
    root = tmp_path_factory.mktemp("gate")
    scene = make_blender_fixture(str(root / "data" / "lego"), n_train=2,
                                 n_test=2, wh=40, n_steps=64)
    field(root, seed=5)
    exp = root / "exp" / "tensorf_lego_VM"
    exp.mkdir(parents=True)
    os.replace(root / "field_TensorVMSplit_5.npz", exp / "tensorf_lego_VM.npz")
    cfg = root / "cfg.txt"
    cfg.write_text(f"dataset_name = blender\ndatadir = {scene}\n")
    return root, str(cfg), str(root / "data"), str(root / "exp")


def _run_gate(root, cfg, datadir, exp_patch, out_name, extra=()):
    out_dir = str(root / out_name)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "iffnerf_tpu_torch.tools.run_accuracy_gate",
         "--allow_random_init", "--config", cfg, "--datadir", datadir,
         "--exp_patch", exp_patch, "--out_dir", out_dir, "--device", "cpu",
         "--id_iters", "3", "--accum_steps", "2", "--gen_points", "64",
         "--id_backbone_depth", "1", *extra],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    return proc, out_dir


def test_gate_chain_exit_codes(gate_setup, monkeypatch, capsys):
    """One chain through the port's pose CLI on the CPU
    (tests/test_accuracy_gate.py's flags at a smaller --gen_points), run as
    a user runs the gate: with bounds no run meets it exits 1, its
    aggregate holding the schema's fields over the 2 test frames. The same
    rows under bounds every run meets exit 0 (the gate's main with its
    pipeline step handing back that run's rows: a second pose CLI would
    cost a second start of its imports). A --dinov2 that names no file
    exits 2 with a diagnostic before any pipeline step (the gate's main,
    in this process). Each verdict line matches its exit code."""
    root, cfg, datadir, exp_patch = gate_setup
    strict, out_dir = _run_gate(root, cfg, datadir, exp_patch, "out_strict",
                                ("--max_median_rot_deg", "0",
                                 "--max_median_trans", "0"))
    assert strict.returncode == 1, strict.stderr[-3000:]
    stats = json.load(open(os.path.join(out_dir, "gate_stats.json")))
    for name in tgate.REQUIRED_STAT_FIELDS:
        assert name in stats, name
    assert stats["n"] == 2
    rows_path = os.path.join(out_dir, "pose_results.json")
    rows = json.load(open(rows_path))
    assert rows and "pred_c2w" in rows[0] and "gt_c2w" in rows[0]
    verdicts = [(1, strict.stdout)]

    monkeypatch.setattr(tgate, "run_pose_pipeline",
                        lambda args, backbone: rows_path)
    loose = tgate.main(["--allow_random_init", "--config", cfg, "--datadir",
                        datadir, "--exp_patch", exp_patch, "--out_dir",
                        str(root / "out_loose"), "--max_median_rot_deg",
                        "1e9", "--max_median_trans", "1e9"])
    assert loose == 0
    verdicts.append((0, capsys.readouterr().out))
    for code, out in verdicts:
        verdict = json.loads(out.strip().splitlines()[-1])
        assert verdict["gate"] == "pose_accuracy"
        assert verdict["passed"] == (code == 0)
        assert verdict["pretrained_backbone"] is False
        assert verdict["n_images"] == 2

    missing = tgate.main(["--allow_random_init", "--config", cfg,
                          "--datadir", datadir, "--exp_patch", exp_patch,
                          "--out_dir", str(root / "out_missing"),
                          "--dinov2", str(root / "no_such.pth")])
    assert missing == 2
    assert "not ported" in capsys.readouterr().err
    assert not os.path.exists(root / "out_missing" / "pose_results.json")


def test_auto_run_paramsets_launches_train_cli(tmp_path, monkeypatch):
    """The sweep's grid is the JAX script's; each run is the port's
    train_cli with the grid's flags, pinned to its card by
    CUDA_VISIBLE_DEVICES (no TPU_VISIBLE_CHIPS), and a second sweep skips
    the runs whose folders exist."""
    jsweep = _jax_script("extra/auto_run_paramsets.py")
    grid = {"data_name": ["lego", "ship"], ("shadingMode", "view_pe"):
            [("Ref", 2), ("MLP_Fea", 4)]}
    assert tsweep.get_param_list(grid) == jsweep.get_param_list(grid)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tsweep, "PARAM_DICT", grid)
    monkeypatch.setattr(tsweep, "DEVICES", ["2", "3"])
    monkeypatch.delenv("TPU_VISIBLE_CHIPS", raising=False)
    runs = []
    monkeypatch.setattr(tsweep.subprocess, "run", lambda cmd, **kw: runs.append(
        (cmd, kw["env"])))
    tsweep.main()
    assert len(runs) == 4
    for cmd, env in runs:
        assert f"{sys.executable} -m iffnerf_tpu_torch.train_cli " in cmd
        assert "--config configs/lego.txt" in cmd
        assert env["CUDA_VISIBLE_DEVICES"] in ("2", "3")
        assert "TPU_VISIBLE_CHIPS" not in env
    tsweep.main()
    assert len(runs) == 4


@pytest.mark.parametrize("script", ["launch_all_blender_training.sh",
                                    "launch_all_tanks_and_temple_training.sh"])
def test_launch_scripts_run_train_cli(tmp_path, script):
    """Each launch script runs the port's train_cli for every scene of the
    JAX script, with its config and expname: run with a ``python`` on the
    PATH that records its arguments."""
    jtext = open(os.path.join(REPO, "tools", script)).read()
    fake = tmp_path / "bin"
    fake.mkdir()
    (fake / "python").write_text(
        f"#!/bin/sh\necho \"$@\" >> {tmp_path / 'calls.txt'}\n")
    os.chmod(fake / "python", 0o755)
    env = dict(os.environ, PATH=f"{fake}:{os.environ['PATH']}",
               IFFNERF_DATA="D")
    subprocess.run(["bash", os.path.join(TOOLS, script)], env=env,
                   check=True, timeout=60)
    calls = (tmp_path / "calls.txt").read_text().splitlines()
    scenes = re.search(r"for obj in ([^;]*);", jtext).group(1).split()
    config = re.search(r"--config (\S+)", jtext).group(1)
    assert len(calls) == len(scenes)
    for call, obj in zip(calls, scenes):
        assert call.startswith("-m iffnerf_tpu_torch.train_cli ")
        assert f"--config {config}" in call
        assert f"--datadir D/{obj}" in call and obj in call.split()[-1]


@pytest.mark.parametrize("shape", ["ball", "cluster"])
def test_gen_fixture_scene_matches_jax(tmp_path, monkeypatch, shape):
    """The torch generator on the CPU against the JAX package's
    extra/gen_fixture_scene.py: each view's uint8 RGBA within 1 (a
    float32 rounding at the truncation to uint8) and equal in at least
    99 % of its entries, the same transforms files."""
    from PIL import Image

    jgen = _jax_script("extra/gen_fixture_scene.py")
    flags = ["--shape", shape, "--wh", "24", "--n_train", "2", "--n_test",
             "1", "--n_steps", "48"]
    tgen.main(["--root", str(tmp_path / "t"), "--device", "cpu", *flags])
    monkeypatch.setattr(sys, "argv", ["gen_fixture_scene", "--root",
                                      str(tmp_path / "j"), *flags])
    jgen.main()
    for split in ("train", "test", "val"):
        name = f"transforms_{split}.json"
        assert json.loads((tmp_path / "t" / name).read_text()) == \
            json.loads((tmp_path / "j" / name).read_text())
    views = sorted((tmp_path / "j").glob("*/r_*.png"))
    assert len(views) == 4
    for path in views:
        want = np.asarray(Image.open(path), np.int16)
        got = np.asarray(Image.open(tmp_path / "t" / path.relative_to(
            tmp_path / "j")), np.int16)
        assert np.abs(got - want).max() <= 1
        assert (got == want).mean() >= 0.99
        assert want[..., 3].max() > 0


def test_tools_import_no_jax():
    """The port's tools import neither jax nor the JAX package, and the
    JAX package's JSON-only tools, shared with the port, import neither
    package either."""
    code = ("import sys\n"
            "import iffnerf_tpu_torch.tools.auto_run_paramsets\n"
            "import iffnerf_tpu_torch.tools.colmap2nerf\n"
            "import iffnerf_tpu_torch.tools.compute_metrics\n"
            "import iffnerf_tpu_torch.tools.compute_scaling_factor\n"
            "import iffnerf_tpu_torch.tools.gen_fixture_scene\n"
            "import iffnerf_tpu_torch.tools.histogram_correlation\n"
            "import iffnerf_tpu_torch.tools.run_accuracy_gate\n"
            "sys.path.insert(0, 'tools')\n"
            "import compute_eval_statistics, per_object_results\n"
            "import statistic_mean, print_sequence_statistics\n"
            "import pose_perturbation_study\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'iffnerf_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
