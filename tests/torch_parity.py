"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

Every input is drawn from a numpy seed and handed to both packages as
numpy arrays; the JAX parameters come from the JAX package's own
``init_id_module`` and reach the port through its weight bridge.
"""

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
