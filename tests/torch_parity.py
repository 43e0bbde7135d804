"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

Every input is drawn from a numpy seed and handed to both packages as
numpy arrays; the JAX parameters come from the JAX package's own
``init_id_module`` and reach the port through its weight bridge.

Importing this module puts torch on one thread in the test process: the
suite runs in several processes at once, and torch's threads, one a core
in each of them, would contend for the same cores (the port's tests ran
3-6 times slower in the suite than alone, a short training run most).
"""

import dataclasses
import importlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import jax
import torch

from iffnerf_tpu.pose import id_module as jid
from iffnerf_tpu.pose.vit import ViTConfig as JViTConfig
from iffnerf_tpu_torch.checkpoint import params_from_numpy
from iffnerf_tpu_torch.pose import id_module as tid
from iffnerf_tpu_torch.pose.vit import ViTConfig as TViTConfig

UP = np.asarray([0.0, 0.0, 1.0], np.float32)

torch.set_num_threads(1)


def configs(depth=1, **kw):
    """(JAX IDConfig, port IDConfig) with the same fields."""
    return (jid.IDConfig(backbone=JViTConfig(depth=depth), **kw),
            tid.IDConfig(backbone=TViTConfig(depth=depth), **kw))


def params(seed, jcfg):
    """(JAX params, port params on the CPU) of one initialisation."""
    jp = jid.init_id_module(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jp, tp


def blob_mask(h, w, dy=30, dx=-40):
    """Elliptic foreground blob: about half the patches stay valid."""
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = h / 2 + dy * h / 800, w / 2 + dx * w / 800
    return ((yy - cy) ** 2 / (h / 4) ** 2 + (xx - cx) ** 2 / (w / 4) ** 2) < 1.0


def scene(seed, n_rays, hw=(96, 96)):
    """-> dict of numpy inputs: img, mask, rays_ori, rays_dirs, rays_rgb."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n_rays, 3)).astype(np.float32)
    return {
        "img": rng.random((*hw, 3), dtype=np.float32),
        "mask": blob_mask(*hw),
        "rays_ori": rng.uniform(-1, 1, (n_rays, 3)).astype(np.float32),
        "rays_dirs": d / np.linalg.norm(d, axis=-1, keepdims=True),
        "rays_rgb": rng.random((n_rays, 3), dtype=np.float32),
    }


def t(a, dtype=None):
    """numpy / JAX array -> CPU tensor (bf16 arrays go through float32)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    out = torch.from_numpy(a.copy())
    return out if dtype is None else out.to(dtype)


def f32(a):
    """JAX array or tensor -> float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


replace = dataclasses.replace


def field(tmp_path, model_name="TensorVMSplit", seed=0,
          grid_size=(20, 20, 20), density_n_comp=None, app_n_comp=(8, 8, 8),
          mask_margin=0, **kw):
    """A small field made by the JAX package (``init_field`` at 20^3 unless
    ``grid_size`` says otherwise, Ref shading, PE 2, a 30 % occupied alpha
    mask over a numpy-seeded [16, 18, 20] volume, its outer ``mask_margin``
    voxels empty), written with its ``save_field`` and read back by the
    port's ``load_field``: -> ((config, params, mask) of JAX, (config,
    params, mask) of the port). ``density_shift`` -1 keeps the alphas of
    random weights well away from 0 and 1."""
    from iffnerf_tpu.checkpoint import save_field
    from iffnerf_tpu.models.field import FieldConfig, init_field, make_alpha_mask
    from iffnerf_tpu_torch.checkpoint import load_field

    vm = model_name == "TensorVMSplit"
    if density_n_comp is None:
        density_n_comp = (4, 4, 4) if vm else (8, 8, 8)
    cfg = FieldConfig(
        model_name=model_name, grid_size=tuple(grid_size),
        density_n_comp=tuple(density_n_comp), app_n_comp=tuple(app_n_comp),
        app_dim=27, shading_mode="Ref", view_pe=2, fea_pe=2, pos_pe=2,
        density_shift=-1.0, **kw)
    params = init_field(jax.random.PRNGKey(seed), cfg)
    vol = (np.random.default_rng(seed).random((16, 18, 20)) < 0.3)
    if mask_margin:
        inner = np.zeros_like(vol)
        inner[(slice(mask_margin, -mask_margin),) * 3] = True
        vol &= inner
    mask = make_alpha_mask(jax.numpy.asarray(vol, np.float32), cfg.aabb_np)
    path = str(tmp_path / f"field_{model_name}_{seed}.npz")
    save_field(path, cfg, params, mask)
    return (cfg, params, mask), load_field(path, device="cpu")


def drawn_field(path, cfg, seed, density=(0.45, 0.35), mask=None):
    """A field of the JAX ``FieldConfig`` ``cfg`` whose leaves numpy draws
    (the JAX package's eager ``init_field`` takes seconds on the CPU): the
    density factors N(density), the appearance factors N(0, 0.3), weights
    N(0, 1/fan_in), biases N(0, 0.3); written at ``path`` with the JAX
    package's ``save_field`` and the alpha mask ``mask`` (JAX's, or None),
    and read back by both packages' ``load_field`` -> ((config, params,
    mask) of JAX, of the port)."""
    from iffnerf_tpu.checkpoint import load_field as jload_field
    from iffnerf_tpu.checkpoint import save_field
    from iffnerf_tpu.models.field import init_field
    from iffnerf_tpu_torch.checkpoint import load_field

    rng = np.random.default_rng(seed)

    def draw(key_path, leaf):
        top, last = key_path[0].key, getattr(key_path[-1], "key", None)
        if top.startswith("density"):
            a = rng.normal(density[0], density[1], leaf.shape)
        else:
            scale = leaf.shape[0] ** -0.5 if last == "w" else 0.3
            a = rng.normal(0.0, scale, leaf.shape)
        return jax.numpy.asarray(a, np.float32)

    shapes = jax.eval_shape(lambda k: init_field(k, cfg),
                            jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(draw, shapes)
    save_field(str(path), cfg, params, mask)
    return jload_field(str(path)), load_field(str(path), device="cpu")


def near_mask_points(mask_volume, aabb, n, seed, spread=0.05):
    """[n, 3] float32 world points around occupied voxel centres of a
    [D, H, W] volume over ``aabb``, jittered by ``spread``."""
    rng = np.random.default_rng(seed)
    zyx = np.argwhere(np.asarray(mask_volume) > 0)
    pick = zyx[rng.integers(0, len(zyx), n)][:, ::-1].astype(np.float64)
    shape = np.asarray(mask_volume.shape[::-1], np.float64)
    aabb = np.asarray(aabb, np.float64)
    pts = aabb[0] + pick / (shape - 1) * (aabb[1] - aabb[0])
    return (pts + rng.normal(0, spread, pts.shape)).astype(np.float32)


def unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def recorded_inerf(monkeypatch, n_iters=2):
    """Wraps the port's ``iffnerf_tpu_torch.inerf.estimate_pose_inerf``
    (which ``test_pose_estimation`` looks up at each call): each call's
    arguments are recorded and it runs with ``n_iters`` iterations -> the
    list of calls, each (positional args, keyword args, result)."""
    import iffnerf_tpu_torch.inerf as tinerf

    calls = []
    real = tinerf.estimate_pose_inerf

    def recorded(*args, **kw):
        out = real(*args, **dict(kw, n_iters=n_iters))
        calls.append((args, kw, out))
        return out

    monkeypatch.setattr(tinerf, "estimate_pose_inerf", recorded)
    return calls


def jax_child(target: str, *args, cpus: int = 1, timeout: float = 1800.0):
    """Starts ``target`` ("module:function" of a module in tests/) on the
    JSON-able ``args`` in a child interpreter whose JAX runs on one CPU
    device with its thread pool held to ``cpus`` cores (its affinity), and
    returns at once -> a function that waits for the child and returns
    what ``target`` returned (JSON). A test process cannot hold its own
    JAX to fewer threads or devices: its backend starts with the
    conftest's 8 virtual devices and every core. So a long JAX reference
    runs beside the port's run in the test process, and off the cores the
    other test processes share."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_multi_thread_eigen=false",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
                   [here, os.path.dirname(here)]
                   + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    cores = ",".join(map(str, sorted(os.sched_getaffinity(0))[-cpus:]))
    # files, not pipes: a child that fills a pipe would wait for this
    # process, which reads only when the port's run is done
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), target, json.dumps(args),
         cores], cwd=here, env=env, stdout=out, stderr=err, text=True)

    def result():
        proc.wait(timeout=timeout)
        out.seek(0)
        err.seek(0)
        if proc.returncode:
            raise RuntimeError(f"{target} failed in its child process "
                               f"(rc {proc.returncode}):\n{err.read()[-4000:]}")
        return json.loads(out.read().strip().splitlines()[-1])

    return result


def _child_main(target: str, args: str, cores: str) -> None:
    # before the XLA backend starts its thread pool, which sizes itself by
    # and inherits this affinity (no Python runs between fork and exec)
    os.sched_setaffinity(0, {int(c) for c in cores.split(",")})
    jax.config.update("jax_platforms", "cpu")
    module, name = target.split(":")
    print(json.dumps(getattr(importlib.import_module(module), name)(
        *json.loads(args))), flush=True)


if __name__ == "__main__":
    _child_main(*sys.argv[1:4])
