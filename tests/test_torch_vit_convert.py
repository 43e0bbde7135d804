"""The port's own DINOv2 converter against the JAX package's, on the CPU:
``pose.vit.convert_torch_dinov2`` on a torch-hub-named state dict of depth
2 drawn from a seed (no weights are downloaded) against the JAX
converter's pytree, the port's ViT on the converted weights against the
JAX ViT on its own, and ``python -m iffnerf_tpu_torch.tools.convert_dinov2``
in a child process, which must import neither jax nor the JAX package and
write an npz that ``pose_cli --backbone_ckpt`` loads (``load_pytree``).

Tolerances: the converted weights exactly (transposes and copies); the
two ViTs' patch tokens within rtol 1e-4 and atol 1e-4 (float32 matmuls,
LayerNorms and softmaxes in two backends).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (torch on one thread)
from iffnerf_tpu.pose import vit as jvit
from iffnerf_tpu_torch.checkpoint import load_pytree
from iffnerf_tpu_torch.pose import vit as tvit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTH, IMG = 2, 112  # a 112 crop: 64 patches keep the JAX reference short


def _state_dict(seed=0, scale=0.05):
    """Random weights in torch-hub DINOv2 naming and layout (numpy)."""
    cfg = jvit.ViTConfig(depth=DEPTH, img_size=IMG)
    rng = np.random.default_rng(seed)
    d, h = cfg.dim, cfg.dim * cfg.mlp_ratio

    def r(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    sd = {"patch_embed.proj.weight": r(d, 3, cfg.patch_size, cfg.patch_size),
          "patch_embed.proj.bias": r(d), "cls_token": r(1, 1, d),
          "pos_embed": r(1, 1 + cfg.n_patches, d),
          "norm.weight": 1.0 + r(d), "norm.bias": r(d)}
    for i in range(DEPTH):
        b = f"blocks.{i}"
        sd.update({
            f"{b}.norm1.weight": 1.0 + r(d), f"{b}.norm1.bias": r(d),
            f"{b}.attn.qkv.weight": r(3 * d, d), f"{b}.attn.qkv.bias": r(3 * d),
            f"{b}.attn.proj.weight": r(d, d), f"{b}.attn.proj.bias": r(d),
            f"{b}.ls1.gamma": r(d),
            f"{b}.norm2.weight": 1.0 + r(d), f"{b}.norm2.bias": r(d),
            f"{b}.mlp.fc1.weight": r(h, d), f"{b}.mlp.fc1.bias": r(h),
            f"{b}.mlp.fc2.weight": r(d, h), f"{b}.mlp.fc2.bias": r(d),
            f"{b}.ls2.gamma": r(d)})
    return sd


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@pytest.fixture(scope="module")
def converted():
    sd = _state_dict()
    jp = jvit.convert_torch_dinov2(sd, jvit.ViTConfig(depth=DEPTH,
                                                      img_size=IMG))
    tp = tvit.convert_torch_dinov2({k: torch.from_numpy(v)
                                    for k, v in sd.items()},
                                   tvit.ViTConfig(depth=DEPTH, img_size=IMG))
    return sd, jp, tp


def test_converter_matches_jax(converted):
    _, jp, tp = converted
    want, got = _flat(jp), _flat(tp)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_converter_takes_numpy_too(converted):
    sd, _, tp = converted
    again = tvit.convert_torch_dinov2(sd, tvit.ViTConfig(depth=DEPTH,
                                                         img_size=IMG))
    for k, v in _flat(tp).items():
        np.testing.assert_array_equal(_flat(again)[k], v)


def test_vit_on_converted_weights_matches_jax(converted):
    _, jp, tp = converted
    img = np.random.default_rng(1).standard_normal((IMG, IMG, 3)).astype(
        np.float32)
    jcfg = jvit.ViTConfig(depth=DEPTH, img_size=IMG)
    want = np.asarray(jax.jit(lambda p, x: jvit.vit_forward_features(
        p, x, jcfg))(jp, jnp.asarray(img)))
    with torch.no_grad():
        got = tvit.vit_forward_features(tp, torch.from_numpy(img),
                                        tvit.ViTConfig(depth=DEPTH,
                                                       img_size=IMG))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_convert_cli_writes_what_pose_cli_loads(tmp_path, converted):
    """The tool in a child process: no jax and no iffnerf_tpu in its
    sys.modules; its npz loads through load_pytree (pose_cli's
    --backbone_ckpt) into the converted weights, with its meta."""
    sd, jp, _ = converted
    ckpt, out = tmp_path / "dinov2.pth", tmp_path / "dinov2.npz"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               ckpt)
    code = ("import sys, runpy\n"
            "sys.argv = ['convert_dinov2', '--torch_ckpt', sys.argv[1],"
            " '--out', sys.argv[2]]\n"
            "runpy.run_module('iffnerf_tpu_torch.tools.convert_dinov2',"
            " run_name='__main__')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'iffnerf_tpu')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run([sys.executable, "-c", code, str(ckpt), str(out)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr
    assert "clean" in run.stdout and f"wrote {out}" in run.stdout
    params, meta = load_pytree(str(out), device="cpu")
    assert meta == {"arch": "dinov2_vits14"}
    want = _flat(jp)
    got = _flat(params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pose_cli_help_names_the_ports_converter():
    from iffnerf_tpu_torch import pose_cli
    import argparse

    parser = argparse.ArgumentParser()
    pose_cli.add_pose_args(parser)
    (action,) = [a for a in parser._actions if a.dest == "backbone_ckpt"]
    assert "iffnerf_tpu_torch.tools.convert_dinov2" in action.help
