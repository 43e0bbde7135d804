"""The TensorCP route of the port's field kernels against the JAX package,
on the CPU: ``ops/cp_features.py``'s plain versions (the kernel's function,
its line gradient and its coordinate gradient) against the JAX package's
``compute_densityfeature`` and ``compute_appfeature`` for CP (``basis_mat``
the identity, so that the appearance feature is the products) and
``jax.vjp`` of them; K3's plain backward against ``jax.vjp`` of
``jnp.take``; the dispatch rule ``use_cp_kernel``; the wrappers' refusals.
The kernels themselves run on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py).

Inputs are drawn by numpy from a seed. Tolerances: the forward within rtol
1e-5 (sigma's sum over ranks in another order; the products are the same
float32 operations); the gradients within 1e-5 of the largest (float32
sums of up to a few hundred terms in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (torch on one thread)
from iffnerf_tpu.models import field as jfield
from iffnerf_tpu_torch.models import field as tfield
from iffnerf_tpu_torch.ops import cp_features as cpf
from iffnerf_tpu_torch.ops.gather import (
    gather_rows,
    gather_rows_backward,
    gather_rows_backward_plain,
)

FIELDS = {"cubic": ((20, 20, 20), 3, 5), "uneven": ((16, 17, 18), 4, 12)}
GRAD_TOL = 1e-5


def _case(name, seed=0, n=300):
    """(lines as numpy, xyz [n, 3] in and beyond [-1, 1], dsigma, dapp)."""
    (gx, gy, gz), rd, ra = FIELDS[name]
    rng = np.random.default_rng(seed)
    lengths = (gz, gy, gx)  # line i is indexed by xyz[2 - i]
    lines = {k: tuple(rng.standard_normal((length, r)).astype(np.float32)
                      for length in lengths)
             for k, r in (("density_line", rd), ("app_line", ra))}
    xyz = rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
    xyz[:8] = np.array([-1.0, 1.0, 0.0], np.float32)[rng.integers(0, 3, (8, 3))]
    dsigma = rng.standard_normal(n).astype(np.float32)
    dapp = rng.standard_normal((n, ra)).astype(np.float32)
    return lines, xyz, dsigma, dapp


def _configs(name):
    (gx, gy, gz), rd, ra = FIELDS[name]
    kw = dict(model_name="TensorCP", grid_size=(gx, gy, gz),
              density_n_comp=(rd,) * 3, app_n_comp=(ra,) * 3, app_dim=ra)
    return jfield.FieldConfig(**kw), tfield.FieldConfig(**kw)


def _jax_features(jcfg, lines, ra):
    """The JAX package's CP features as a function of (density lines, app
    lines, xyz): (sigma, the app products through an identity basis_mat)."""
    eye = jnp.eye(ra, dtype=jnp.float32)

    @jax.jit  # one compilation in place of op-by-op dispatch
    def fn(dens, app, xyz):
        params = {"density_line": dens, "app_line": app,
                  "basis_mat": {"w": eye}}
        return (jfield.compute_densityfeature(jcfg, params, xyz),
                jfield.compute_appfeature(jcfg, params, xyz))
    return fn


def _t(tree):
    return {k: tuple(torch.from_numpy(a) for a in v) for k, v in tree.items()}


@pytest.mark.parametrize("name", list(FIELDS))
def test_cp_plain_forward_matches_jax(name):
    lines, xyz, _, _ = _case(name)
    jcfg, tcfg = _configs(name)
    ra = FIELDS[name][2]
    want_s, want_a = _jax_features(jcfg, lines, ra)(
        lines["density_line"], lines["app_line"], jnp.asarray(xyz))
    sigma, app = cpf.cp_features(tcfg, _t(lines), torch.from_numpy(xyz))
    np.testing.assert_allclose(sigma.numpy(), np.asarray(want_s), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(app.numpy(), np.asarray(want_a), rtol=1e-5,
                               atol=1e-6)
    # density only, and the route compute_features takes on the CPU
    only, none = cpf.cp_features(tcfg, _t(lines), torch.from_numpy(xyz),
                                 with_app=False)
    assert none is None and torch.equal(only, sigma)


@pytest.mark.parametrize("name", list(FIELDS))
@pytest.mark.parametrize("with_app", [False, True])
def test_cp_plain_gradients_match_jax_vjp(name, with_app):
    lines, xyz, dsigma, dapp = _case(name, seed=1)
    jcfg, tcfg = _configs(name)
    ra = FIELDS[name][2]
    fn = _jax_features(jcfg, lines, ra)
    _, vjp = jax.vjp(fn, lines["density_line"], lines["app_line"],
                     jnp.asarray(xyz))
    up_app = dapp if with_app else np.zeros_like(dapp)
    g_dens, g_app, g_xyz = vjp((jnp.asarray(dsigma), jnp.asarray(up_app)))
    tl = _t(lines)
    t_dapp = torch.from_numpy(dapp) if with_app else None
    got = cpf.cp_features_backward(tcfg, tl, torch.from_numpy(xyz),
                                   torch.from_numpy(dsigma), t_dapp)
    want = {"density_line": g_dens, "app_line": g_app}
    assert set(got) == ({"density_line", "app_line"} if with_app
                        else {"density_line"})
    for k in got:
        for a, b in zip(got[k], want[k]):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=GRAD_TOL * np.abs(b).max())
    dxyz = cpf.cp_features_coords_grad(tcfg, tl, torch.from_numpy(xyz),
                                       torch.from_numpy(dsigma), t_dapp)
    g_xyz = np.asarray(g_xyz)
    np.testing.assert_allclose(dxyz.numpy(), g_xyz, rtol=0,
                               atol=GRAD_TOL * np.abs(g_xyz).max())


def test_cp_autograd_on_the_cpu_is_the_plain_gradient():
    """The CPU route is torch's autograd through the samplers: the same
    gradients as the plain backward wrappers."""
    lines, xyz, dsigma, dapp = _case("uneven", seed=2)
    _, tcfg = _configs("uneven")
    leaves = {k: tuple(torch.from_numpy(a).requires_grad_() for a in v)
              for k, v in lines.items()}
    pts = torch.from_numpy(xyz).requires_grad_()
    sigma, app = cpf.cp_features(tcfg, leaves, pts)
    (sigma * torch.from_numpy(dsigma)).sum().backward(retain_graph=True)
    (app * torch.from_numpy(dapp)).sum().backward()
    want = cpf.cp_features_backward_plain(_t(lines), torch.from_numpy(xyz),
                                          torch.from_numpy(dsigma),
                                          torch.from_numpy(dapp))
    for k in want:
        for leaf, w in zip(leaves[k], want[k]):
            torch.testing.assert_close(leaf.grad, w, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(pts.grad, cpf.cp_features_coords_grad_plain(
        _t(lines), torch.from_numpy(xyz), torch.from_numpy(dsigma),
        torch.from_numpy(dapp)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fused_eval", ["auto", "on", "off"])
def test_cp_compute_features_on_the_cpu_is_the_plain_route(fused_eval):
    lines, xyz, _, _ = _case("cubic", seed=3)
    _, tcfg = _configs("cubic")
    tcfg = tcfg.replace(fused_eval=fused_eval, app_dim=7)
    params = dict(_t(lines), basis_mat={"w": torch.from_numpy(
        np.random.default_rng(4).standard_normal((5, 7)).astype(np.float32))})
    x = torch.from_numpy(xyz)
    sigma, app = tfield.compute_features(tcfg, params, x)
    want_s, want_p = cpf.cp_features_plain(params, x)
    assert torch.equal(sigma, want_s)
    assert torch.equal(app, want_p @ params["basis_mat"]["w"])
    assert torch.equal(tfield.compute_densityfeature(tcfg, params, x), want_s)
    assert torch.equal(tfield.compute_appfeature(tcfg, params, x), app)


@pytest.mark.parametrize("model,fused_eval,device,want", [
    ("TensorCP", "auto", "cpu", False), ("TensorCP", "auto", "cuda", True),
    ("TensorCP", "on", "cuda", True), ("TensorCP", "off", "cuda", False),
    ("TensorCP", "auto", "meta", False), ("TensorCP", "on", "cpu", False),
    ("TensorVMSplit", "auto", "cuda", False),
    ("TensorVMSplit", "on", "cpu", False),
])
def test_use_cp_kernel(model, fused_eval, device, want):
    """The CP kernel on CUDA unless fused_eval is "off"; never for VM,
    whose kernel use_fused_eval decides (never for CP)."""
    cfg = tfield.FieldConfig(model_name=model, fused_eval=fused_eval)
    assert tfield.use_cp_kernel(cfg, device) is want
    assert tfield.use_cp_kernel(cfg, torch.device(device)) is want
    if model == "TensorCP":
        assert tfield.use_fused_eval(cfg, device) is False


@pytest.mark.parametrize("take", [
    "vm_field", "float64_xyz", "bad_xyz_shape", "float64_line",
    "strided_line", "ranks_differ", "lengths_differ", "meta_device"])
def test_cp_features_refuses_before_any_launch(take):
    lines, xyz, _, _ = _case("uneven", seed=5, n=17)
    _, tcfg = _configs("uneven")
    params, x = _t(lines), torch.from_numpy(xyz)
    if take == "vm_field":
        tcfg = tcfg.replace(model_name="TensorVMSplit")
    elif take == "float64_xyz":
        x = x.double()
    elif take == "bad_xyz_shape":
        x = x[:, :2]
    elif take == "float64_line":
        params["app_line"] = (params["app_line"][0].double(),
                              *params["app_line"][1:])
    elif take == "strided_line":
        params["density_line"] = (params["density_line"][0][::2],
                                  *params["density_line"][1:])
    elif take == "ranks_differ":
        params["app_line"] = (params["app_line"][0][:, :5],
                              *params["app_line"][1:])
    elif take == "lengths_differ":
        params["app_line"] = (params["app_line"][0][:-1].contiguous(),
                              *params["app_line"][1:])
    else:
        x = x.to("meta")
        params = {k: tuple(a.to("meta") for a in v)
                  for k, v in params.items()}
    before = cpf.cp_features.launches
    with pytest.raises(ValueError):
        if take in ("ranks_differ", "lengths_differ"):
            cpf.kernel_layout(params, True)
        else:
            cpf.cp_features(tcfg, params, x)
    assert cpf.cp_features.launches == before


@pytest.mark.parametrize("dims,want_d,want_a,log_cw", [
    ((20, 20, 20, 3, 5), True, True, 3),          # 8 columns cover 8 ranks
    ((500, 480, 520, 96, 288), True, True, 4),    # lego's CP: 16 columns
    ((500, 480, 520, 96, 288), True, False, 4),
    ((130, 140, 150, 1, 1), True, False, 0),
    ((100, 100, 100, 47, 5), False, True, 3),
])
def test_cp_backward_columns(dims, want_d, want_a, log_cw):
    """A block's column slice: the widest power of two up to 32 whose
    accumulators of the three lines fit BWD_MAX_SMEM, no wider than the
    columns asked for."""
    got = cpf.backward_columns(dims, want_d, want_a)
    assert got == log_cw
    assert sum(dims[:3]) * 4 << got <= cpf.BWD_MAX_SMEM


def test_cp_backward_refuses_lines_too_long_for_shared_memory():
    with pytest.raises(ValueError, match="shared"):
        cpf.backward_columns((10000, 10000, 10000, 4, 4), True, True)


@pytest.mark.parametrize("n,slices,sms,want", [
    (7_090_176, 24, 132, 22), (1021, 1, 132, 1), (0, 3, 132, 1),
    (100_000, 1, 132, 49), (10 ** 9, 1, 132, 528)])
def test_cp_backward_chunks(n, slices, sms, want):
    """Four blocks an SM in all (two waves at lego's 96 KB of accumulators),
    no chunk under 2 048 samples, at least one."""
    assert cpf.backward_chunks(n, slices, sms) == want


@pytest.mark.parametrize("rows,cols", [(9, 4), (30, 1)])
def test_gather_rows_backward_plain_matches_jax_take_vjp(rows, cols):
    """jnp.take's rule: -R <= i < 0 wraps, anything else outside [0, R)
    gives a NaN row, whose upstream XLA's scatter drops."""
    rng = np.random.default_rng(rows)
    table = rng.standard_normal((rows, cols)).astype(np.float32)
    idx = rng.integers(-rows - 3, rows + 3, 64).astype(np.int32)
    idx[:4] = [0, rows - 1, -1, -rows]
    up = rng.standard_normal((64, cols)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jnp.take(t, jnp.asarray(idx), axis=0), table)
    (want,) = vjp(jnp.asarray(up))
    got = gather_rows_backward(torch.from_numpy(up), torch.from_numpy(idx),
                               rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(got, gather_rows_backward_plain(
        torch.from_numpy(up), torch.from_numpy(idx), rows))
    # autograd through the CPU forward gives the same gradient
    leaf = torch.from_numpy(table).requires_grad_()
    out = gather_rows(leaf, torch.from_numpy(idx))
    ok = torch.isfinite(out).all(-1)
    (out[ok] * torch.from_numpy(up)[ok]).sum().backward()
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("take", ["float64", "idx_int64", "idx_count",
                                  "rows_zero"])
def test_gather_rows_backward_refuses(take):
    up, idx, rows = torch.zeros((5, 3)), torch.zeros(5, dtype=torch.int32), 4
    if take == "float64":
        up = up.double()
    elif take == "idx_int64":
        idx = idx.long()
    elif take == "idx_count":
        idx = idx[:4]
    else:
        rows = 0
    with pytest.raises(ValueError):
        gather_rows_backward(up, idx, rows)
