"""Port parity for the data mesh (``iffnerf_tpu_torch/parallel``,
``runtime.py``) and the routes it shards: ``score_rays(axis_name=...)``,
``estimate_pose_single_sharded``, ``render_chunked(mesh=...)``, the train
step under a mesh and ``test_pose_estimation(mesh=...)``.

A group of 4 gloo ranks runs once for the module, each rank a child
process (``tests/torch_sharded_worker.py``, which imports no JAX) that
writes its results to an ``.npz``; the parametrised tests read them. The
JAX package runs the same inputs meanwhile on a 4-device sub-mesh of the
test process's virtual devices, at ``tests/test_parallel.py``'s shapes
and tolerances. Weights reach the ranks through the JAX package's
``save_pytree`` and ``save_field`` and the port's loaders. Every
tolerance is stated beside its test.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from iffnerf_tpu.checkpoint import save_pytree
from iffnerf_tpu.models import FieldConfig
from iffnerf_tpu.models.field import make_alpha_mask
from iffnerf_tpu.parallel import make_mesh, pad_to_multiple, shard_rays
from iffnerf_tpu.pose import estimate_pose_single_sharded
from iffnerf_tpu.pose import id_module as jid
from iffnerf_tpu.pose.trainer import make_id_optimizer, make_id_train_step
from iffnerf_tpu.pose.vit import ViTConfig as JViTConfig
from iffnerf_tpu.render import render_chunked
from iffnerf_tpu.train import trainer as jtrainer
from iffnerf_tpu_torch.parallel import mesh as tmesh
from iffnerf_tpu_torch.pose.trainer import LEARNING_RATES

import torch_sharded_worker as worker
from torch_parity import blob_mask, drawn_field, near_mask_points, unit

RANKS = 4
# the ID module's leaves whose gradients are float32 cancellation noise
# (tests/test_torch_id_train.py)
ID_INVARIANT = ("k_proj/b", "ray_mlp2/1/b")
HERE = os.path.dirname(os.path.abspath(__file__))
JCFG = jid.IDConfig(backbone=JViTConfig(img_size=28, patch_size=14, dim=32,
                                        depth=1, num_heads=4),
                    resize_size=32, crop_size=28)


def _id_params(seed):
    """The ID module's tree with leaves drawn by numpy (the JAX package's
    eager init takes seconds): weights N(0, 1/fan_in), the rest N(0, 0.3)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jid.init_id_module(k, JCFG),
                            jax.random.PRNGKey(0))

    def draw(path, leaf):
        w = getattr(path[-1], "key", None) == "w"
        return rng.normal(0.0, leaf.shape[0] ** -0.5 if w else 0.3,
                          leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _inputs(tmp, rng):
    """Writes id.npz, field.npz (trained: 20^3 with an alpha mask),
    render_field.npz (tests/test_parallel.py's 16^3 field) and inputs.npz
    to ``tmp`` -> (JAX ID params, JAX fields (config, params, mask) to train
    and to render, the jitters' keys, the inputs). Leaves are numpy draws
    (``_id_params``, ``torch_parity.drawn_field``)."""
    jp = _id_params(1)
    save_pytree(str(tmp / "id.npz"), jp)
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    vol = np.random.default_rng(3).random((16, 18, 20)) < 0.3
    tcfg = FieldConfig(grid_size=(20, 20, 20), density_n_comp=(4, 4, 4),
                       app_n_comp=(8, 8, 8), app_dim=27, shading_mode="Ref",
                       view_pe=2, fea_pe=2, pos_pe=2, density_shift=-1.0)
    (jcfg, fp, fmask), _ = drawn_field(
        tmp / "field.npz", tcfg, 3, mask=make_alpha_mask(
            jnp.asarray(vol, np.float32), tcfg.aabb_np))
    rcfg = FieldConfig(grid_size=(16, 16, 16), density_n_comp=(4, 4, 4),
                       app_n_comp=(8, 8, 8), app_dim=9, shading_mode="Ref",
                       feature_c=16, view_pe=2, fea_pe=2, step_ratio=1.0)
    (rcfg, rparams, _), _ = drawn_field(tmp / "render_field.npz", rcfg, 4,
                                        density=(0.8, 0.35))

    n = 1600
    d = rng.standard_normal((n, 3)).astype(np.float32)
    inp = {
        "rays_ori": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        "rays_dirs": d / np.linalg.norm(d, axis=-1, keepdims=True),
        "rays_rgb": rng.uniform(0, 1, (n, 3)).astype(np.float32),
        "img": rng.uniform(0, 1, (48, 48, 3)).astype(np.float32),
        "mask": np.ones((48, 48), np.float32),
        "up": np.asarray([0.0, 0.0, 1.0], np.float32),
        "pad_1000": rng.standard_normal((1000, 7)).astype(np.float32),
        "pad_1024": rng.standard_normal((1024, 3)).astype(np.float32),
    }
    # tests/test_parallel.py's rays: origins in [-3, 3]^3, random directions
    d = rng.standard_normal((1000, 3)).astype(np.float32)
    inp["render_rays"] = np.concatenate(
        [rng.uniform(-3, 3, (1000, 3)).astype(np.float32),
         d / np.linalg.norm(d, axis=-1, keepdims=True),
         np.full((1000, 1), 0.01, np.float32)], -1)

    # training rays at the field's occupied voxels
    def rays_at(count, seed):
        target = near_mask_points(fmask.volume, jcfg.aabb_np, count, seed)
        ori = unit(rng.standard_normal((count, 3))) * 4.0
        return np.concatenate([ori, unit(target - ori),
                               np.full((count, 1), 1e-3)], -1).astype(
                                   np.float32)

    inp["pool_rays"] = rays_at(2000, 6)
    inp["pool_rgbs"] = rng.random((2000, 4), dtype=np.float32)
    inp["train_idx"] = np.stack([rng.permutation(2000)[:worker.TRAIN_BATCH]
                                 for _ in worker.TRAIN_WEIGHTS])
    keys = [jax.random.PRNGKey(20 + k) for k in range(len(worker.TRAIN_WEIGHTS))]
    inp["train_jitter"] = np.stack([np.asarray(jax.random.uniform(
        key, (worker.TRAIN_BATCH, 1), jnp.float32)) for key in keys])
    frames = np.concatenate([rng.random((2, 48, 48, 3), dtype=np.float32),
                             np.broadcast_to(blob_mask(48, 48)[None, ..., None],
                                             (2, 48, 48, 1))], -1)
    inp["frames"] = frames.reshape(2, 48 * 48, 4).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    poses[:, :3, 3] = rng.uniform(-2, 2, (2, 3))
    inp["poses"] = poses
    inp["K"] = np.array([[40.0, 0, 24], [0, 40.0, 24], [0, 0, 1]], np.float32)
    # tests/test_parallel.py's ID-module step: two 40x40 images, full
    # masks, poses near the identity; and the same with a NaN pose
    inp["id_imgs"] = rng.uniform(0, 1, (2, 40, 40, 3)).astype(np.float32)
    inp["id_masks"] = np.ones((2, 40, 40), np.float32)
    inp["id_poses"] = (np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
                       + 0.01 * rng.standard_normal((2, 4, 4)).astype(
                           np.float32))
    inp["id_poses_nan"] = inp["id_poses"].copy()
    inp["id_poses_nan"][1, 0, 3] = np.nan
    np.savez(tmp / "inputs.npz", **inp)
    return jp, (jcfg, fp, fmask), (rcfg, rparams), keys, inp


def _jax_reference(jp, jfield, rfield, keys, inp):
    """The JAX package on a 4-device sub-mesh of the virtual devices."""
    jmesh = make_mesh(jax.devices()[:RANKS])
    ref = {}
    for n in worker.PADDED:
        padded, orig = pad_to_multiple(jnp.asarray(inp[f"pad_{n}"]), RANKS)
        arr = shard_rays(jmesh, padded)
        ref[f"pad_{n}"] = [np.asarray(s.data) for s in sorted(
            arr.addressable_shards, key=lambda s: s.index[0].start)]
        ref[f"pad_{n}_orig"] = orig
    ro, rd, rr = (jnp.asarray(inp[k]) for k in ("rays_ori", "rays_dirs",
                                                 "rays_rgb"))
    bank = jid.ray_bank(jp, JCFG, ro, rd, rr)
    for route, b in (("unbanked", None), ("banked", bank)):
        out = estimate_pose_single_sharded(
            jp, JCFG, jnp.asarray(inp["img"]), jnp.asarray(inp["mask"]), ro,
            rd, rr, jnp.asarray(inp["up"]), mesh=jmesh, k=worker.K, bank=b)
        ref[f"estimate_{route}"] = [np.asarray(a) for a in out]
    ref["render"] = [np.asarray(a) for a in render_chunked(
        *rfield, None, inp["render_rays"], chunk=worker.RENDER_CHUNK,
        n_samples=worker.RENDER_SAMPLES, white_bg=True, mesh=jmesh)]

    jcfg, fp, fmask = jfield
    state = jtrainer.make_optimizer(fp, worker.LR_SPATIAL, worker.LR_NETWORK,
                                    worker.LR_FACTOR)
    step = jtrainer.make_train_step(
        jcfg, state.tx, has_mask=True, n_samples=worker.TRAIN_SAMPLES,
        ndc_ray=False, rgb_channels=4, mesh=jmesh, **worker.TRAIN_SPEC)
    params = jax.tree_util.tree_map(jnp.array, fp)  # the step donates them
    opt_state, mses, firsts = state.tx.init(params), [], []
    for k, weights in enumerate(worker.TRAIN_WEIGHTS):
        params, opt_state, mse = step(
            params, opt_state, fmask, jnp.asarray(inp["pool_rays"]),
            jnp.asarray(inp["pool_rgbs"]), jnp.asarray(inp["train_idx"][k]),
            keys[k], jnp.ones(3),
            {name: jnp.float32(v) for name, v in weights.items()})
        mses.append(float(mse))
        firsts.append(worker.flat(jax.tree_util.tree_map(np.asarray, params)))
    before = worker.flat(jax.tree_util.tree_map(np.asarray, fp))
    ref["train"] = (firsts[-1], np.asarray(mses),
                    {k: firsts[0][k] - v for k, v in before.items()})

    # the ID-module step with the candidate rays sharded over the mesh
    # (tests/test_parallel.py::test_sharded_id_train_step_matches_single)
    # (tests/test_parallel.py::test_sharded_id_train_step_matches_single);
    # the same step with _kept_gradients in Adam's place gives its gradients
    sh, rep = NamedSharding(jmesh, P("data")), NamedSharding(jmesh, P())
    outs = []
    for tx in (make_id_optimizer(jp), _kept_gradients()):
        step = make_id_train_step(JCFG, tx, accum_steps=worker.ID_ACCUM)
        p = jax.device_put(jax.tree_util.tree_map(jnp.copy, jp), rep)
        outs.append(step(p, tx.init(p), jnp.asarray(inp["id_imgs"]),
                         jnp.asarray(inp["id_masks"]),
                         jnp.asarray(inp["id_poses"]),
                         *(jax.device_put(jnp.asarray(inp[k]), sh)
                           for k in ("rays_ori", "rays_dirs", "rays_rgb"))))
    (new_p, _, loss), (_, grads, _) = outs
    new_p, grads = (worker.flat(jax.tree_util.tree_map(np.asarray, t))
                    for t in (new_p, grads))
    before = worker.flat(jax.tree_util.tree_map(np.asarray, jp))
    ref["id"] = (new_p, float(loss),
                 {k: new_p[k] - v for k, v in before.items()}, grads)
    return ref


def _kept_gradients():
    """An optax transformation that applies no update and keeps the
    gradients it is given as its state: the ID step's gradients (after
    its division by the accumulation) come back as its optimizer state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda g, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, g), g))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4 ranks' outputs (a list of dicts, by rank), the JAX package's
    reference, the inputs and the working directory. The ranks run while
    the JAX reference is computed here."""
    tmp = tmp_path_factory.mktemp("sharded")
    jp, jfield, rfield, keys, inp = _inputs(tmp, np.random.default_rng(17))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.dirname(HERE)
    procs = []
    for r in range(RANKS):
        log = open(tmp / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_sharded_worker.py"),
             str(tmp), str(r), str(RANKS)], env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    try:
        ref = _jax_reference(jp, jfield, rfield, keys, inp)
        for proc, _ in procs:
            proc.wait(timeout=600)
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for r, (proc, _) in enumerate(procs):
        assert proc.returncode == 0, (tmp / f"rank{r}.log").read_text()[-4000:]
    ranks = []
    for r in range(RANKS):
        with np.load(tmp / f"rank{r}.npz") as f:
            ranks.append({k: f[k] for k in f.files})
    return ranks, ref, inp, tmp


def _gathered(ranks, key):
    return np.concatenate([out[key] for out in ranks])


@pytest.mark.parametrize("n", worker.PADDED)
def test_pad_and_shard_match_jax(runs, n):
    """pad_to_multiple (edge) and shard_rays: each rank's rows are JAX's
    shard on the device of its index, exactly, and the padded whole is
    JAX's."""
    ranks, ref, inp, _ = runs
    for r, out in enumerate(ranks):
        assert tuple(out["shard/rank"]) == (r, RANKS)
        np.testing.assert_array_equal(out[f"shard/pad_{n}"], ref[f"pad_{n}"][r])
        assert int(out[f"shard/pad_{n}_orig"]) == ref[f"pad_{n}_orig"] == n
    padded, orig = tmesh.pad_to_multiple(torch.from_numpy(inp[f"pad_{n}"]),
                                         RANKS)
    np.testing.assert_array_equal(padded.numpy(),
                                  np.concatenate(ref[f"pad_{n}"]))
    assert orig == n


@pytest.mark.parametrize("route", ["unbanked", "banked"])
def test_score_rays_shards_match_jax(runs, route):
    """score_rays(axis_name="data") on each rank's rows, the shards in rank
    order: the sharded estimate's scores of the JAX package within rtol
    1e-5 and atol 1e-6 (tests/test_parallel.py's rule)."""
    ranks, ref, _, _ = runs
    got = _gathered(ranks, f"shard/score_rays_{route}")
    np.testing.assert_allclose(got, ref[f"estimate_{route}"][1], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("route", ["unbanked", "banked"])
def test_sharded_estimate_matches_jax(runs, route):
    """estimate_pose_single_sharded on 4 ranks against the JAX package's on
    4 devices (1 600 rays, k = 32): scores within rtol 1e-5 and atol 1e-6,
    the same top-k set, c2w within rtol 1e-4 and atol 1e-5."""
    ranks, ref, _, _ = runs
    c2w, scores, idx, weights = (ranks[0][f"rep/estimate_{route}/{k}"]
                                 for k in ("c2w", "scores", "idx", "weights"))
    jc2w, jscores, jidx, jweights = ref[f"estimate_{route}"]
    np.testing.assert_allclose(scores, jscores, rtol=1e-5, atol=1e-6)
    assert set(idx.tolist()) == set(jidx.tolist())
    np.testing.assert_allclose(weights, jweights, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(c2w, jc2w, rtol=1e-4, atol=1e-5)


def test_sharded_render_matches_jax(runs):
    """render_chunked with the mesh, tests/test_parallel.py's field and
    1 000 rays (a count 4 ranks do not divide, chunks of 512, 16 samples)
    against the JAX package's on its mesh: rgb within
    rtol 1e-5 and atol 1e-6, depth within 1e-5 (tests/test_parallel.py's
    rule); and against the port without a mesh, the same rule."""
    ranks, ref, _, _ = runs
    out = ranks[0]
    for got, want, atol in ((out["rep/render/rgb"], ref["render"][0], 1e-6),
                            (out["rep/render/depth"], ref["render"][1], 1e-5)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(out["rep/render/rgb"], out["plain/render/rgb"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out["rep/render/depth"],
                               out["plain/render/depth"], rtol=1e-5, atol=1e-5)


def test_sharded_train_steps_match_jax(runs):
    """Two train steps of 256 rays (every loss term on, the mask, Adam) on
    4 ranks, handed the JAX step's jitter, against the JAX package's
    make_train_step(mesh=...) on 4 devices with the same indices: the mse
    within rtol 1e-5, every parameter within rtol 1e-4 and atol 1e-6.

    Adam's first update of an entry is -lr g / (|g| + eps): where JAX's
    first gradient is not 0 and |g| lies within 9 eps (its first update
    under 0.9 of the rate: the L1 term alone gives a density entry about
    1e-8), float32 summation order in g (the port unsharded misses JAX
    there alike) moves the update by a share of the rate. Those entries
    (about an eighth here) are held within 1e-3 of their group's rate
    (tests/test_torch_train_loop.py's Adam rule)."""
    ranks, ref, _, _ = runs
    want, jmse, first = ref["train"]
    prefix = f"rep/train_{worker.TRAIN_BATCH}/"
    got = {k[len(prefix):]: v for k, v in ranks[0].items()
           if k.startswith(prefix) and k != prefix + "mse"}
    assert got.keys() == want.keys()
    for name, w in want.items():
        lr = (worker.LR_NETWORK if name.split("/")[0] in ("basis_mat", "shading")
              else worker.LR_SPATIAL)
        near_eps = (first[name] != 0) & (np.abs(first[name]) < 0.9 * lr)
        atol = np.where(near_eps, 1e-3 * lr, 1e-6)
        diff = np.abs(got[name] - w)
        assert (diff <= atol + 1e-4 * np.abs(w)).all(), (name, diff.max())
    np.testing.assert_allclose(ranks[0][prefix + "mse"], jmse, rtol=1e-5)


@pytest.mark.parametrize("batch", [worker.TRAIN_BATCH, worker.UNEVEN_BATCH])
def test_sharded_steps_match_unsharded(runs, batch):
    """Two train steps on 4 ranks against the port's steps without a mesh:
    every parameter within rtol 1e-4 and atol 1e-6, the mse within rtol
    1e-5. At 254 rays, which 4 ranks split 63/64/63/64, the per-ray terms
    weighted by each rank's rows keep the steps the unsharded ones."""
    ranks, _, _, _ = runs
    out = ranks[0]
    prefix = f"train_{batch}/"
    names = [k[len("plain/" + prefix):] for k in out
             if k.startswith("plain/" + prefix)]
    assert len(names) > 2
    for name in names:
        rtol = 1e-5 if name == "mse" else 1e-4
        np.testing.assert_allclose(out["rep/" + prefix + name],
                                   out["plain/" + prefix + name], rtol=rtol,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("case", ["divisible", "fallback"])
def test_pose_estimation_mesh_matches_no_mesh(runs, case):
    """test_pose_estimation with the mesh against no mesh, on 2 frames:
    the poses within 1e-5, the same recalls and averages within rtol
    1e-5. At 1 598 rays, which 4 ranks do not divide, the mesh is dropped
    with the JAX package's "pose mesh disabled" line. Only rank 0 logs and
    writes its .npz dump."""
    ranks, _, _, tmp = runs
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out[f"rep/pose_{case}/pred_c2w"],
                                   out[f"plain/pose_{case}/pred_c2w"],
                                   atol=1e-5)
        np.testing.assert_array_equal(out[f"rep/pose_{case}/recall"],
                                      out[f"plain/pose_{case}/recall"])
        np.testing.assert_allclose(out[f"rep/pose_{case}/avgs"],
                                   out[f"plain/pose_{case}/avgs"], rtol=1e-5)
        logged = str(out[f"log/pose_{case}_rep"])
        disabled = "pose mesh disabled: 1598 rays not divisible by mesh size 4"
        assert (disabled in logged) == (case == "fallback" and r == 0)
        assert ("Translation Error" in logged) == (r == 0)
        dump = tmp / f"dump_{case}_rep_{r}" / "sample_results_0.npz"
        assert dump.exists() == (r == 0)


def _id_run(out, tag, case):
    prefix = f"{tag}/id_{case}/"
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


def test_sharded_id_step_matches_jax(runs):
    """One ID-module step on 4 ranks (ViT dim 32, depth 1, 1 600 rays, two
    40x40 images, accumulation 2) against the JAX package's
    make_id_train_step with the rays placed by NamedSharding(P("data")) on
    4 devices. The loss within rtol 1e-5. Each leaf's gradient (the same
    JAX step with Adam's place taken by _kept_gradients) within 1e-4 of
    its largest magnitude, an invariant bias's noise under 1e-4 of its
    layer's weight gradient in both (tests/test_torch_id_train.py's rule
    for the port against JAX). Every parameter within rtol 1e-4 and atol
    1e-6, except entries whose first JAX update is not 0 and under 0.9 of
    their rate in magnitude (Adam's lr g / (|g| + eps) on a gradient within
    9 eps, where float32 summation order moves the update by a share of
    the rate: test_sharded_train_steps_match_jax's rule), held within 1e-3
    of the rate. At these shapes the gradients are about 1e-8, so such
    entries are 245 286 of the 246 688 (measured on the CPU): the
    parameters check little, and the gradients carry the test."""
    ranks, ref, _, _ = runs
    want, jloss, first, jgrads = ref["id"]
    got = _id_run(ranks[0], "rep", "even")
    np.testing.assert_allclose(float(got["loss"]), jloss, rtol=1e-5)
    for name, g in jgrads.items():
        mine = got["g/" + name]
        if name in ID_INVARIANT:
            scale = np.abs(jgrads[name[:-1] + "w"]).max()
            assert max(np.abs(g).max(), np.abs(mine).max()) < 1e-4 * scale
        else:
            assert np.abs(g).max() > 0, name
            err = np.abs(mine - g).max()
            assert err <= 1e-4 * np.abs(g).max(), (name, err)
    for name, w in want.items():
        lr = LEARNING_RATES[name.split("/")[0]]
        near_eps = (first[name] != 0) & (np.abs(first[name]) < 0.9 * lr)
        atol = np.where(near_eps, 1e-3 * lr, 1e-6)
        diff = np.abs(got["p/" + name] - w)
        assert (diff <= atol + 1e-4 * np.abs(w)).all(), (name, diff.max())


def _grads_close(got, want, name):
    """rtol 1e-5 and atol 1e-6 x max|g| of the leaf; an invariant bias
    (its gradient is float32 cancellation noise in any summation order)
    within 1e-6 of its layer's largest weight gradient."""
    g, w = got["g/" + name], want["g/" + name]
    if name in ID_INVARIANT:
        scale = np.abs(want["g/" + name[:-1] + "w"]).max()
        assert np.abs(g - w).max() <= 1e-6 * scale, (name, np.abs(g - w).max())
    else:
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("case", ["even", "uneven", "nan"])
def test_sharded_id_step_matches_unsharded(runs, case):
    """One ID-module step on 4 ranks against the port's step without a
    mesh on the same rays: each leaf's gradient after the step (Adam is
    nearly blind to a gradient's scale, so the gradients are held, not
    only the parameters) under _grads_close's rule, the loss within rtol
    1e-5, the parameters within rtol 1e-4 and atol 1e-6 (the invariant
    biases within 1e-3 of their rate). "uneven": 1 598 rays, split
    399/400/399/400; "nan": the second image's pose NaN, so its loss is
    not finite on any rank and the step is the first image's alone."""
    ranks, _, _, _ = runs
    got = _id_run(ranks[0], "rep", case)
    want = _id_run(ranks[0], "plain", case)
    assert got.keys() == want.keys() and len(got) > 3
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert np.isfinite(got["loss"])
    for key in want:
        if key.startswith("g/"):
            _grads_close(got, want, key[2:])
        elif key.startswith("p/"):
            name = key[2:]
            atol = (1e-3 * LEARNING_RATES[name.split("/")[0]]
                    if name in ID_INVARIANT else 1e-6)
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       atol=atol, err_msg=name)


def test_sharded_id_step_drops_the_nan_image(runs):
    """With the second image's pose NaN the step is the first image's
    alone with the same accumulation: without a mesh bit-equal (loss,
    gradients, parameters); on each of the 4 ranks under
    test_sharded_id_step_matches_unsharded's rule."""
    ranks, _, _, _ = runs
    first = _id_run(ranks[0], "plain", "first")
    for out in ranks:
        plain = _id_run(out, "plain", "nan")
        assert plain.keys() == first.keys()
        for key in first:
            np.testing.assert_array_equal(plain[key], first[key], err_msg=key)
        got = _id_run(out, "rep", "nan")
        np.testing.assert_allclose(got["loss"], first["loss"], rtol=1e-5)
        for key in first:
            if key.startswith("g/"):
                _grads_close(got, first, key[2:])


def test_psum_gradient_matches_one_process_sum(runs):
    """The differentiable psum on 4 ranks: its value and each rank's input
    gradient against one process summing the four inputs and
    differentiating the sum of the four ranks' losses."""
    ranks, _, _, _ = runs
    xs = [(torch.arange(6.0) * (r + 1)).requires_grad_(True)
          for r in range(RANKS)]
    y = torch.stack(xs).sum(0)
    sum((torch.tensor([1.0, -1.0, 2.0, 0.5, 3.0, -2.0]) * (r + 1) ** 2 * y)
        .sum() for r in range(RANKS)).backward()
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["shard/psum_value"], y.detach().numpy(),
                                   rtol=1e-6)
        np.testing.assert_allclose(out["shard/psum_grad"], xs[r].grad.numpy(),
                                   rtol=1e-6)


@pytest.mark.parametrize("what", ["estimate", "render", "train", "pose",
                                  "id"])
def test_ranks_return_the_same(runs, what):
    """What every rank returns (the estimates, the render, the trained
    parameters, the pose rows) is bit-equal to rank 0's."""
    ranks, _, _, _ = runs
    keys = [k for k in ranks[0] if k.startswith(f"rep/{what}")]
    assert keys
    for out in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(out[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("what", ["estimate_unbanked", "estimate_banked",
                                  "render", f"train_{worker.UNEVEN_BATCH}",
                                  "id_even"])
def test_one_rank_group_equals_no_mesh(runs, what):
    """On a group of one rank, each route is bit-equal to its call without
    a mesh (the sharded estimates to the exact unbanked and banked routes;
    the uneven batch's two steps; the ID-module step's loss, gradients and
    parameters)."""
    ranks, _, _, _ = runs
    for out in ranks:
        keys = [k[4:] for k in out if k.startswith(f"one/{what}/")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(out["one/" + k], out["plain/" + k],
                                          err_msg=k)


def test_ranks_import_no_jax(runs):
    """The ranks never imported jax or iffnerf_tpu."""
    ranks, _, _, _ = runs
    for out in ranks:
        assert str(out["log/imports"]) == ""
