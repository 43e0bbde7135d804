"""Port parity for the small modules: nn, encoding, exact top-k, pose
geometry and solve guards, the weight bridge, the import boundary and the
device rule. JAX on the CPU is the oracle; inputs come from numpy seeds."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from iffnerf_tpu import nn as jnn
from iffnerf_tpu.checkpoint import save_pytree
from iffnerf_tpu.ops.encoding import positional_encoding as jpe
from iffnerf_tpu.pose import geometry as jgeo
from iffnerf_tpu.pose.solve import solve_pose_from_topk as jsolve
from iffnerf_tpu_torch import nn as tnn
from iffnerf_tpu_torch.checkpoint import load_pytree
from iffnerf_tpu_torch.ops.encoding import positional_encoding as tpe
from iffnerf_tpu_torch.ops.topk import exact_topk
from iffnerf_tpu_torch.pose import geometry as tgeo
from iffnerf_tpu_torch.pose.solve import solve_pose_from_topk as tsolve

from torch_parity import UP, configs, f32, params, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("freqs", [1, 6, 8])
def test_positional_encoding_matches(freqs):
    x = np.random.default_rng(freqs).uniform(-1, 1, (257, 3)).astype(np.float32)
    # sin/cos of |x| * 2^7 differ by float32 argument rounding: 1e-5
    np.testing.assert_allclose(f32(tpe(t(x), freqs)), f32(jpe(jnp.asarray(x), freqs)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_apply_matches(dtype):
    layers = jnn.mlp_init(jax.random.PRNGKey(3), [141, 256, 384])
    layers = jax.tree_util.tree_map(lambda a: a.astype(dtype), layers)
    tl = tuple({k: t(v) for k, v in layer.items()} for layer in layers)
    x = np.random.default_rng(3).standard_normal((64, 141)).astype(np.float32)
    want = f32(jnn.mlp_apply(layers, jnp.asarray(x).astype(dtype)))
    got = f32(tnn.mlp_apply(tl, t(x).to(getattr(torch, dtype))))
    # f32: summation order only; bf16: a rounding flip upstream moves an
    # output by about one bf16 ulp (2^-8 relative)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_linear_init_bounds_and_generator():
    g = torch.Generator().manual_seed(0)
    layer = tnn.linear_init(g, 141, 256)
    assert layer["w"].shape == (141, 256) and layer["b"].shape == (256,)
    bound = 1 / np.sqrt(141)
    assert float(layer["w"].abs().max()) <= bound
    assert float(layer["b"].abs().max()) <= bound
    again = tnn.linear_init(torch.Generator().manual_seed(0), 141, 256)
    assert torch.equal(layer["w"], again["w"])


@pytest.mark.parametrize("n,k,ties", [
    (540000, 100, False),
    (4096, 64, True),
    (999, 5, True),
    (20000, 7, False),
])
def test_exact_topk_matches_lax(n, k, ties):
    rng = np.random.default_rng(n + k)
    scores = (rng.integers(0, 50, n) if ties else rng.random(n)).astype(np.float32)
    w_ref, i_ref = jax.lax.top_k(jnp.asarray(scores), k)
    w, i = exact_topk(t(scores), k)
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


def test_exact_topk_negative_values_and_ties():
    scores = np.asarray([-3.0, 2.0, -0.5, 2.0, -3.0, 7.0, -0.5, 2.0],
                        np.float32)
    w, i = exact_topk(t(scores), 8)
    assert i.tolist() == [5, 1, 3, 7, 2, 6, 0, 4]
    assert w.tolist() == sorted(scores.tolist(), reverse=True)


def _rays(seed, k):
    rng = np.random.default_rng(seed)
    ori = rng.uniform(-1, 1, (k, 3)).astype(np.float32)
    d = rng.standard_normal((k, 3)).astype(np.float32)
    return ori, d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_geometry_matches():
    ori, dirs = _rays(0, 100)
    w = np.random.default_rng(1).random(100).astype(np.float32)
    m = np.random.default_rng(2).standard_normal((3, 3)).astype(np.float32)
    j, tt = jnp.asarray, t
    pairs = [
        (jgeo.det3(j(m)), tgeo.det3(tt(m))),
        (jgeo.inv3(j(m)), tgeo.inv3(tt(m))),
        (jgeo.solve3(j(m), j(ori[:3])), tgeo.solve3(tt(m), tt(ori[:3]))),
        (jgeo.compute_line_intersection_impl2(j(ori), j(dirs), j(w)),
         tgeo.compute_line_intersection_impl2(tt(ori), tt(dirs), tt(w))),
        (jgeo.make_rotation_mat(j(dirs[0]), j(UP)),
         tgeo.make_rotation_mat(tt(dirs[0]), tt(UP))),
        (jgeo.exclude_negatives(j(ori[0]), j(ori), j(dirs)),
         tgeo.exclude_negatives(tt(ori[0]), tt(ori), tt(dirs))),
        (jgeo.compute_translation_error(j(ori[0]), j(ori[1])),
         tgeo.compute_translation_error(tt(ori[0]), tt(ori[1]))),
        (jgeo.compute_angular_error(j(m), j(m + 0.1)),
         tgeo.compute_angular_error(tt(m), tt(m + 0.1))),
    ]
    for want, got in pairs:
        # closed forms in float32, summed in another order: 1e-5
        np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)


def test_parallel_rays_give_identity_c2w():
    """Parallel rays make R singular: the intersection is NaN and the
    solve returns the identity, in both packages."""
    k = 16
    ori = np.random.default_rng(4).uniform(-1, 1, (k, 3)).astype(np.float32)
    dirs = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (k, 1))
    w = np.ones(k, np.float32)
    center = tgeo.compute_line_intersection_impl2(t(ori), t(dirs))
    assert torch.isnan(center).all()
    c2w = tsolve(t(ori), t(dirs), t(w), t(UP))
    np.testing.assert_array_equal(c2w.numpy(), np.eye(4, dtype=np.float32))
    np.testing.assert_array_equal(
        np.asarray(jsolve(jnp.asarray(ori), jnp.asarray(dirs), jnp.asarray(w),
                          jnp.asarray(UP))),
        c2w.numpy())


def test_solve_pose_from_topk_matches_with_duplicate_origins():
    ori, dirs = _rays(5, 100)
    ori[10] = ori[20]  # both dropped by the origin dedup
    cam = np.asarray([0.3, -2.0, 1.5], np.float32)
    dirs = cam - ori + np.random.default_rng(6).normal(0, 0.05, ori.shape)
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    w = np.random.default_rng(7).random(100).astype(np.float32)
    want = np.asarray(jsolve(jnp.asarray(ori), jnp.asarray(dirs),
                             jnp.asarray(w), jnp.asarray(UP)))
    got = tsolve(t(ori), t(dirs), t(w), t(UP)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_round_trip(tmp_path, dtype):
    """JAX save_pytree -> port load_pytree keeps every leaf, its layout
    and (through the bf16 bit view) its exact value."""
    jcfg, _ = configs()
    jp, _ = params(1, jcfg)
    jp = jax.tree_util.tree_map(lambda a: a.astype(dtype), jp)
    path = tmp_path / "id_module.npz"
    save_pytree(str(path), jp, meta={"iters": 3})
    tp, meta = load_pytree(str(path), device="cpu")
    assert meta == {"iters": 3}
    assert tp["backbone"]["patch_embed"]["w"].shape == (14, 14, 3, 384)
    assert isinstance(tp["backbone"]["blocks"], tuple)
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    tleaves = jax.tree_util.tree_leaves(tp)
    assert len(jleaves) == len(tleaves)
    for (path_, a), b in zip(jleaves, tleaves):
        assert b.dtype == getattr(torch, dtype), path_
        np.testing.assert_array_equal(f32(b), f32(a), err_msg=str(path_))


def test_port_imports_no_jax():
    """The port and chip_smoke.py's imports leave jax and iffnerf_tpu out
    of sys.modules."""
    code = textwrap.dedent("""
        import sys
        import iffnerf_tpu_torch
        import iffnerf_tpu_torch.checkpoint
        import iffnerf_tpu_torch.config
        import iffnerf_tpu_torch.data
        import iffnerf_tpu_torch.data.base
        import iffnerf_tpu_torch.data.blender
        import iffnerf_tpu_torch.data.colmap
        import iffnerf_tpu_torch.data.llff
        import iffnerf_tpu_torch.data.mip360
        import iffnerf_tpu_torch.data.nsvf
        import iffnerf_tpu_torch.data.pose_utils
        import iffnerf_tpu_torch.data.rays_np
        import iffnerf_tpu_torch.data.tankstemple
        import iffnerf_tpu_torch.data.your_own
        import iffnerf_tpu_torch.device
        import iffnerf_tpu_torch.geometry
        import iffnerf_tpu_torch.geometry.rays
        import iffnerf_tpu_torch.inerf
        import iffnerf_tpu_torch.inerf.estimate
        import iffnerf_tpu_torch.models
        import iffnerf_tpu_torch.models.field
        import iffnerf_tpu_torch.models.render
        import iffnerf_tpu_torch.models.shading
        import iffnerf_tpu_torch.nn
        import iffnerf_tpu_torch.ops
        import iffnerf_tpu_torch.ops._build
        import iffnerf_tpu_torch.ops.banked_attention
        import iffnerf_tpu_torch.ops.cp_features
        import iffnerf_tpu_torch.ops.encoding
        import iffnerf_tpu_torch.ops.field_features
        import iffnerf_tpu_torch.ops.fused_ray_attention
        import iffnerf_tpu_torch.ops.gather
        import iffnerf_tpu_torch.ops.grid_sample
        import iffnerf_tpu_torch.ops.ide
        import iffnerf_tpu_torch.ops.image
        import iffnerf_tpu_torch.ops.ray_march
        import iffnerf_tpu_torch.ops.sh
        import iffnerf_tpu_torch.ops.topk
        import iffnerf_tpu_torch.parallel
        import iffnerf_tpu_torch.parallel.mesh
        import iffnerf_tpu_torch.pose
        import iffnerf_tpu_torch.pose.eval_utils
        import iffnerf_tpu_torch.pose.geometry
        import iffnerf_tpu_torch.pose.id_module
        import iffnerf_tpu_torch.pose.isocell
        import iffnerf_tpu_torch.pose.model_utils
        import iffnerf_tpu_torch.pose.sampling
        import iffnerf_tpu_torch.pose.solve
        import iffnerf_tpu_torch.pose.test
        import iffnerf_tpu_torch.pose.trainer
        import iffnerf_tpu_torch.pose.vit
        import iffnerf_tpu_torch.pose_cli
        import iffnerf_tpu_torch.runtime
        import iffnerf_tpu_torch.tools.convert_dinov2
        import iffnerf_tpu_torch.tools.k3_time
        import iffnerf_tpu_torch.train
        import iffnerf_tpu_torch.train.trainer
        import chip_smoke
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith("jax.")
               or m == "iffnerf_tpu" or m.startswith("iffnerf_tpu.")]
        assert not bad, bad
        print("clean")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_entry_points_raise_without_cuda(monkeypatch):
    """Without device=, entry points ask for CUDA and raise where it is
    absent; they never fall back to the CPU."""
    from iffnerf_tpu_torch.checkpoint import params_from_numpy
    from iffnerf_tpu_torch.pose import (
        estimate_pose_single_banked,
        init_id_module,
        ray_bank,
        train_id_module,
    )
    from iffnerf_tpu_torch import pose_cli
    from iffnerf_tpu_torch.inerf import estimate_pose_inerf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = configs()
    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_id_module(g, tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"w": np.zeros(3, np.float32)})
    z = np.zeros((8, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        ray_bank({}, tcfg, z, z, z)
    with pytest.raises(RuntimeError, match="CUDA"):
        estimate_pose_single_banked({}, tcfg, np.zeros((96, 96, 3)),
                                    np.ones((96, 96)), torch.zeros(8, 384),
                                    z, z, UP)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_id_module({}, tcfg, lambda: (z, z, z), None, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        pose_cli.main(["--exp_patch", ".", "--out_path", "out.json"])
    with pytest.raises(RuntimeError, match="CUDA"):
        estimate_pose_inerf(np.eye(4), np.zeros((8, 8, 4)), np.eye(3), None,
                            {}, None, sampling_strategy="random")
    from types import SimpleNamespace

    from iffnerf_tpu_torch.render.renderer import evaluation_path
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluation_path(None, {}, None, np.eye(4)[None],
                        SimpleNamespace(img_wh=(4, 3), K=np.eye(3)[None]))


def test_kernel_wrappers_take_plain_version_only_on_cpu():
    """A tensor that is neither on the CPU nor on a CUDA card is refused,
    not computed with the plain version."""
    from iffnerf_tpu_torch.ops.banked_attention import banked_scores_fused
    from iffnerf_tpu_torch.models.field import FieldConfig
    from iffnerf_tpu_torch.ops.field_features import (
        TABLES,
        field_features,
        field_features_coords_grad,
    )
    from iffnerf_tpu_torch.ops.fused_ray_attention import fused_ray_scores

    bank = torch.empty((64, 384), device="meta")
    q = torch.empty((256, 384), device="meta")
    pv = torch.empty(256, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="no banked-scoring kernel"):
        banked_scores_fused(bank, q, pv)
    with pytest.raises(ValueError, match="no fused ray-scoring kernel"):
        fused_ray_scores({}, q, pv, torch.empty((64, 141), device="meta"))
    cfg = FieldConfig(grid_size=(4, 4, 4), density_n_comp=(4, 4, 4),
                      app_n_comp=(4, 4, 4))
    field = {k: tuple(torch.empty((4, 4, 4) if "plane" in k else (4, 4),
                                  device="meta") for _ in range(3))
             for k in TABLES}
    xyz = torch.empty((5, 3), device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="no field-feature kernel"):
        field_features(cfg, field, xyz)
    with pytest.raises(ValueError, match="no field-feature kernel"):
        field_features_coords_grad(cfg, field, xyz,
                                   torch.empty(5, device="meta"))
