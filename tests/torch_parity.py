"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

Every input is drawn from a numpy seed and handed to both packages as
numpy arrays; the JAX parameters come from the JAX package's own
``init_id_module`` and reach the port through its weight bridge.
"""

import contextlib
import dataclasses

import numpy as np
import jax
import torch

from iffnerf_tpu.pose import id_module as jid
from iffnerf_tpu.pose.vit import ViTConfig as JViTConfig
from iffnerf_tpu_torch.checkpoint import params_from_numpy
from iffnerf_tpu_torch.pose import id_module as tid
from iffnerf_tpu_torch.pose.vit import ViTConfig as TViTConfig

UP = np.asarray([0.0, 0.0, 1.0], np.float32)


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


@contextlib.contextmanager
def one_torch_thread():
    """torch on one thread while open: a run of thousands of small ops
    (a short training run on the CPU) slows most when its threads contend
    for the cores with other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
