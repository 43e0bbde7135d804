"""The yardstick of field_features' backward kernel against the JAX package,
on the ray-ordered samples that exercise the kernel's merging.

On the card the backward kernel is held to ``field_features_backward_plain``
(``tests/test_torch_cuda_kernels.py``); here that plain version is held to
``jax.grad`` of ``compute_densityfeature`` and ``compute_appfeature`` on the
same kind of inputs: rays in the order training samples them, half a texel
apart, along the axes (consecutive samples share rows longest), the
diagonals and both, crossing ray ends inside the kernel's runs, leaving
[-1, 1], with stretches of zero upstream gradient. A 32^3 TensorVMSplit
field with unequal ranks; tables and inputs from numpy seeds. Tolerance:
1e-5 of each leaf's largest |grad|, as ``test_torch_field_train.py`` holds
the port's autograd to JAX (float32 sums of up to a hundred terms a texel
in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iffnerf_tpu.models import field as jfield
from iffnerf_tpu_torch.ops import field_features as tff
from iffnerf_tpu_torch.tools.ff_time import (
    AXES,
    DIAGONALS,
    ray_ordered_samples,
    ray_upstream,
)

GRID = (32, 32, 32)
DENSITY, APP, APP_DIM = (4, 3, 5), (8, 6, 7), 27
CONFIG = jfield.FieldConfig(grid_size=GRID, density_n_comp=DENSITY,
                            app_n_comp=APP, app_dim=APP_DIM)
PER_RAY = 2 * max(GRID) + 37  # about two grid widths: in, across and out
N = 808                       # samples of every layout
LAYOUTS = {"axes": (AXES, 5), "diagonals": (DIAGONALS, 11),
           "rays": (AXES + DIAGONALS, 17)}


@pytest.fixture(scope="module")
def tables():
    """The four table kinds and basis_mat as numpy float32 (planes [H, W,
    R], lines [L, R]), normal around 0.5, and the same as torch tensors."""
    rng = np.random.default_rng(6)
    params = {}
    for kind, ranks in (("density", DENSITY), ("app", APP)):
        params[f"{kind}_plane"] = tuple(
            (0.5 + 0.1 * rng.standard_normal((GRID[m1], GRID[m0], ranks[i])))
            .astype(np.float32) for i, (m0, m1) in enumerate(tff.MAT_MODE))
        params[f"{kind}_line"] = tuple(
            (0.5 + 0.1 * rng.standard_normal((GRID[tff.VEC_MODE[i]], ranks[i])))
            .astype(np.float32) for i in range(3))
    params["basis_mat"] = {"w": (0.1 * rng.standard_normal(
        (sum(APP), APP_DIM))).astype(np.float32)}
    port = {k: tuple(torch.from_numpy(a) for a in params[k]) for k in tff.TABLES}
    return params, port


def _samples(layout):
    """N samples of rays in the layout's directions, ray-major, and the
    upstream gradients of ``ray_upstream``."""
    dirs, seed = LAYOUTS[layout]
    rounds = -(-N // (PER_RAY * len(dirs)))
    xyz = np.concatenate([ray_ordered_samples(GRID, dirs, PER_RAY, seed + k,
                                              spread=0.9)
                          for k in range(rounds)])[:N]
    dsigma, wa = ray_upstream(N, APP_DIM, seed)
    return xyz, dsigma, wa


@functools.partial(jax.jit, static_argnums=0)
def _jax_grad(with_app, params, xyz, dsigma, wa):
    names = list(tff.TABLES if with_app else tff.TABLES[:2])

    def loss(sub):
        q = dict(params, **sub)
        total = jnp.sum(jfield.compute_densityfeature(CONFIG, q, xyz) * dsigma)
        if with_app:
            total = total + jnp.sum(
                jfield.compute_appfeature(CONFIG, q, xyz) * wa)
        return total

    return jax.grad(loss)({k: params[k] for k in names})


@pytest.mark.parametrize("with_app", [True, False])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_backward_plain_matches_jax_on_rays(tables, layout, with_app):
    """field_features_backward_plain against jax.grad of sum(sigma *
    dsigma) (+ sum(app_feature * wa), whose products' upstream is wa @
    basis_mat^T) in the density (and appearance) tables."""
    params, port = tables
    xyz, dsigma, wa = _samples(layout)
    assert (np.abs(xyz) > 1).any() and (dsigma == 0).any()
    want = _jax_grad(with_app, params, xyz, dsigma, wa)
    dapp = None
    if with_app:
        dapp = torch.from_numpy(
            (wa.astype(np.float64) @ params["basis_mat"]["w"].T).astype(np.float32))
    got = tff.field_features_backward_plain(
        port, torch.from_numpy(xyz), torch.from_numpy(dsigma), dapp)
    assert sorted(got) == sorted(want)
    for name in want:
        for i, (a, b) in enumerate(zip(got[name], want[name])):
            a, b = a.numpy(), np.asarray(b)
            assert a.shape == b.shape, f"{name}[{i}]"
            scale = max(float(np.abs(b).max()), 1e-30)
            err = float(np.abs(a - b).max())
            assert err <= 1e-5 * scale, f"{name}[{i}]: {err} > 1e-5 x {scale}"
