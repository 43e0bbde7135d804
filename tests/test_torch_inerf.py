"""Port parity for the iNeRF refinement (``iffnerf_tpu_torch/inerf``)
against the JAX package's ``iffnerf_tpu/inerf/estimate.py``, on the CPU:
the exponential map and its gradient, soft-Dice, the pixel candidates,
the learning-rate schedule, one step's loss and pose gradient,
``render_rays``' gradient in the rays, a 3-iteration loop fed the JAX
package's own draws, and ``pose_cli --algorithm_type inerf_dice``.

Fields are made by the JAX package at 32^3 (``torch_parity.field``) and
reach the port through its checkpoint bridge; the observation and the
camera are the fixture scene's (``tests/fixtures.py``). Their alpha masks
leave the outer two voxels empty: a ray's first sample lies on the AABB's
face, so whether it counts is decided by the rounding of o + d t, which
the two packages round apart, and where the mask lets it count, a change
of 1e-7 in a ray moves its gradient by half its size (in float64 too). The
JAX references are jitted once a module. Every tolerance is stated beside
its test.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from iffnerf_tpu.checkpoint import save_field
from iffnerf_tpu.geometry.rays import get_ray_directions_Ks
from iffnerf_tpu.inerf import estimate as jinerf
from iffnerf_tpu.models import render as jrender
from iffnerf_tpu_torch import pose_cli
from iffnerf_tpu_torch.data.blender import load_blender as tload_blender
from iffnerf_tpu_torch.inerf import estimate as tinerf
from iffnerf_tpu_torch.models import render as trender

from fixtures import make_blender_fixture
from torch_parity import field, recorded_inerf, t

BATCH = 64


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("inerf_scene") / "lego")
    return make_blender_fixture(root, n_train=2, n_test=2, wh=40, n_steps=64)


@pytest.fixture(scope="module")
def frame(scene):
    """The fixture's test frame 0: (RGBA [H, W, 4], K [3, 3], c2w [4, 4],
    a start pose 6 degrees about z and 0.05 off it), numpy float32."""
    ds = tload_blender(scene, split="test", is_stack=True)
    w, h = ds.img_wh
    obs = np.asarray(ds.all_rgbs[0], np.float32).reshape(h, w, 4)
    gt = np.asarray(ds.poses[0], np.float32)
    ang = np.deg2rad(6.0)
    rot = np.eye(4, dtype=np.float32)
    rot[:2, :2] = [[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]]
    start = rot @ gt
    start[:3, 3] += 0.05
    return obs, np.asarray(ds.K[0], np.float32), gt, start


@pytest.fixture(scope="module", params=["TensorVMSplit", "TensorCP"])
def fields(request, tmp_path_factory):
    return field(tmp_path_factory.mktemp("inerf_field"), request.param,
                 seed=7, grid_size=(32, 32, 32), mask_margin=2)


@pytest.fixture(scope="module")
def vm(tmp_path_factory):
    return field(tmp_path_factory.mktemp("inerf_vm"), seed=7,
                 grid_size=(32, 32, 32), mask_margin=2)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("theta", [0.7, 1e-6])
def test_camera_transfer_matches_jax(theta):
    """The pose and the gradient of sum(pose * M) in (w, v, theta), near
    the loop's start (theta 1e-6) too: float32 products of a few terms,
    1e-6 absolute on the pose, 1e-5 of the largest gradient."""
    rng = np.random.default_rng(2)
    start = np.eye(4, dtype=np.float32)
    start[:3] = rng.standard_normal((3, 4)).astype(np.float32)
    w, v = (rng.standard_normal(3).astype(np.float32) * 0.3 for _ in range(2))
    m = rng.standard_normal((4, 4)).astype(np.float32)

    def jf(w_, v_, th):
        return jnp.sum(jinerf.camera_transfer(w_, v_, th, jnp.asarray(start))
                       * m)

    want = np.asarray(jinerf.camera_transfer(
        jnp.asarray(w), jnp.asarray(v), jnp.float32(theta),
        jnp.asarray(start)))
    jgrads = jax.grad(jf, argnums=(0, 1, 2))(
        jnp.asarray(w), jnp.asarray(v), jnp.float32(theta))
    leaves = [t(w).requires_grad_(), t(v).requires_grad_(),
              torch.tensor(theta, dtype=torch.float32, requires_grad=True)]
    got = tinerf.camera_transfer(*leaves, t(start))
    torch.sum(got * t(m)).backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    for leaf, jg in zip(leaves, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(leaf.grad.numpy(), jg, rtol=0,
                                   atol=1e-5 * max(np.abs(jg).max(), 1e-30))


def test_soft_dice_loss_matches_jax():
    """The loss and its gradient in the logits: float32 sums of 1024
    terms, rtol 1e-6 on the loss, 1e-5 of the largest gradient."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((1024, 1)).astype(np.float32)
    labels = (rng.uniform(0, 1, (1024, 1)) > 0.5).astype(np.float32)
    jl, jg = jax.value_and_grad(jinerf.soft_dice_loss)(
        jnp.asarray(logits), jnp.asarray(labels))
    leaf = t(logits).requires_grad_()
    loss = tinerf.soft_dice_loss(leaf, t(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-5 * float(np.abs(jg).max()))


@pytest.mark.parametrize("strategy,batch", [
    ("random", 64), ("interest_points", 8), ("interest_points", 4096),
    ("interest_regions", 64)])
def test_build_candidates_is_bit_equal(strategy, batch):
    """The host candidate sets of every strategy on a textured image (SIFT
    finds keypoints): POI alone when there are enough, padded with the
    other pixels when not, dilated regions; bit-equal."""
    rng = np.random.default_rng(4)
    img = np.kron(rng.random((16, 16, 4)), np.ones((4, 4, 1))).astype(
        np.float32)
    want = jinerf._build_candidates(img, strategy, 35, 1, batch)
    got = tinerf._build_candidates(img, strategy, 35, 1, batch)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if strategy == "interest_points":
        assert (len(got) == len(tinerf.find_poi(img[..., :3]))) == (batch == 8)


@pytest.mark.parametrize("k", [0, 1, 100, 799])
def test_learning_rate_matches_optax(k):
    """The step size at iteration k against optax.exponential_decay(lrate,
    100, 0.8) at count k (float32 there): rtol 1e-6."""
    want = float(optax.exponential_decay(0.02, 100, 0.8)(k))
    np.testing.assert_allclose(tinerf.learning_rate(0.02, k), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# one step, the render's ray gradient
# ---------------------------------------------------------------------------


def _jax_rays_setup(obs, cam_k):
    """The JAX loop's camera grids, as ``_run`` builds them."""
    h, w = obs.shape[:2]
    ori, dx, dy = (a[0] for a in get_ray_directions_Ks(
        h, w, jnp.asarray(cam_k).reshape(1, 3, 3)))
    dirs_norm = ori / jnp.linalg.norm(ori, axis=-1, keepdims=True)
    dxn = jnp.linalg.norm(dx - ori, axis=-1)
    dyn = jnp.linalg.norm(dy - ori, axis=-1)
    return dirs_norm, (0.5 * (dxn + dyn))[..., None] * (2.0 / jnp.sqrt(12.0))


def _jax_loss_at_pose(jfield, pose, obs, grids, xy, bg, dice):
    """The JAX package's loss_fn (iffnerf_tpu/inerf/estimate.py:165-191)
    rebuilt from its public pieces, at the c2w ``pose`` -> (total, rgb)."""
    jcfg, jp, jmask = jfield
    dirs_norm, radii_cam = grids
    bx, by = xy[:, 0], xy[:, 1]
    rays_d = dirs_norm[by, bx] @ pose[:3, :3].T
    rays_d = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = jnp.broadcast_to(pose[:3, 3], rays_d.shape)
    rays = jnp.concatenate([rays_o, rays_d, radii_cam[by, bx]], axis=-1)
    target = jnp.asarray(obs)[by, bx]
    rgb_t, alpha_t = target[:, :3], target[:, 3:]
    target_rgb = rgb_t * alpha_t + bg * (1.0 - alpha_t)
    rgb, _, acc, _, _, _ = jrender.render_rays(jcfg, jp, jmask, rays,
                                               is_train=False, bg_color=bg)
    rgb_loss = jnp.mean(jnp.square(rgb - target_rgb))
    total = rgb_loss
    if dice:
        op = jnp.clip(acc, 1e-3, 1.0 - 1e-3)
        total = total + jinerf.soft_dice_loss(op[:, None], alpha_t)
    return total, rgb_loss


def _pixels(obs, n, seed):
    h, w = obs.shape[:2]
    flat = np.random.default_rng(seed).choice(h * w, n, replace=False)
    return np.stack([flat % w, flat // w], -1).astype(np.int64)


@pytest.fixture(scope="module")
def jax_loss(vm, frame):
    """The JAX loss_fn at a c2w, jitted once: (pose [4, 4], pixels [B, 2],
    background [3]) -> (rgb loss, dice loss)."""
    obs, cam_k, _, _ = frame
    grids = _jax_rays_setup(obs, cam_k)

    def both(pose, xy, bg):
        total, rgb = _jax_loss_at_pose(vm[0], pose, obs, grids, xy, bg, True)
        return rgb, total - rgb
    return jax.jit(both)


STEP_BACKGROUNDS = {"random": np.asarray([0.3, 0.8, 0.45], np.float32),
                    "white": np.ones(3, np.float32),
                    "black": np.zeros(3, np.float32)}


@pytest.fixture(scope="module")
def jax_steps(jax_loss, frame):
    """jax.value_and_grad of the rgb and the dice loss in (w, v, theta) at
    a pose 0.1 from the start, on 64 pixels, for each background ->
    {background: ((rgb, dice), (d rgb, d dice), p, pixels)}."""
    _, _, _, start = frame
    p = (np.random.default_rng(5).standard_normal(7) * 0.1).astype(np.float32)
    xy = _pixels(frame[0], BATCH, 6)

    def parts(pp, bg):
        pose = jinerf.camera_transfer(pp[:3], pp[3:6], pp[6],
                                      jnp.asarray(start))
        return jnp.stack(jax_loss(pose, jnp.asarray(xy), bg))

    value_and_jac = jax.jit(lambda pp, bg: (parts(pp, bg),
                                            jax.jacrev(parts)(pp, bg)))
    out = {}
    for name, bg in STEP_BACKGROUNDS.items():
        val, jac = value_and_jac(jnp.asarray(p), jnp.asarray(bg))
        out[name] = (np.asarray(val), np.asarray(jac), p, xy)
    return out


@pytest.mark.parametrize("bg_name", sorted(STEP_BACKGROUNDS))
@pytest.mark.parametrize("dice", [False, True])
def test_one_step_matches_jax(vm, frame, jax_steps, dice, bg_name):
    """One iteration's total and rgb loss and their gradient in (w, v,
    theta) at a pose 0.1 from the start, 64 pixels: the port's loss
    against the JAX package's loss_fn rebuilt from its public pieces, with
    and without dice, each background. float32 through the render's
    sums in another order: rtol 1e-5 on the losses, 1e-4 of the largest
    gradient component."""
    obs, cam_k, _, start = frame
    _, (tcfg, tp, tmask) = vm
    (jrgb, jdice), (jg_rgb, jg_dice), p, xy = jax_steps[bg_name]
    jtotal = jrgb + jdice if dice else jrgb
    jgrad = jg_rgb + jg_dice if dice else jg_rgb
    dirs_norm, radii = tinerf.ray_grids(*obs.shape[:2], cam_k)
    leaf = t(p).requires_grad_()
    total, rgb_loss = tinerf._loss(tcfg, tp, tmask, leaf, t(start), t(obs),
                                   t(dirs_norm), t(radii), t(xy),
                                   t(STEP_BACKGROUNDS[bg_name]), dice)
    (grad,) = torch.autograd.grad(total, leaf)
    np.testing.assert_allclose(float(total.detach()), jtotal, rtol=1e-5)
    np.testing.assert_allclose(float(rgb_loss.detach()), jrgb, rtol=1e-5)
    assert np.abs(jgrad).max() > 0
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=0,
                               atol=1e-4 * float(np.abs(jgrad).max()))


def test_render_rays_ray_gradient_matches_jax(fields, frame):
    """sum(rgb * a) + sum(acc * b) + sum(alpha * c) differentiated in
    rays_chunk [64, 7] (origins, directions, radii) with the alpha mask
    on, VM and CP fields: the sample points, the AABB entry's z values and
    the view directions into the Ref head carry the gradient, the mask
    lookup and the depth none. Against jax.grad of the JAX package's
    render_rays: float32 through sums in another order, 1e-4 of the
    largest |grad|."""
    obs, cam_k, _, start = frame
    (jcfg, jp, jmask), (tcfg, tp, tmask) = fields
    rng = np.random.default_rng(8)
    dirs_norm, radii = tinerf.ray_grids(*obs.shape[:2], cam_k)
    xy = _pixels(obs, BATCH, 9)
    rays_d = dirs_norm[xy[:, 1], xy[:, 0]] @ start[:3, :3].T
    rays = np.concatenate([np.broadcast_to(start[:3, 3], rays_d.shape), rays_d,
                           radii[xy[:, 1], xy[:, 0]]], -1).astype(np.float32)
    s = jcfg.n_samples
    a = rng.standard_normal((BATCH, 3)).astype(np.float32)
    b = rng.standard_normal(BATCH).astype(np.float32)
    c = rng.standard_normal((BATCH, s)).astype(np.float32)

    def jloss(r):
        rgb, _, acc, alpha, _, _ = jrender.render_rays(jcfg, jp, jmask, r,
                                                       is_train=False)
        return jnp.sum(rgb * a) + jnp.sum(acc * b) + jnp.sum(alpha * c)

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(rays)))
    leaf = t(rays).requires_grad_()
    rgb, _, acc, alpha, _, _ = trender.render_rays(tcfg, tp, tmask, leaf,
                                                   is_train=False)
    (torch.sum(rgb * t(a)) + torch.sum(acc * t(b))
     + torch.sum(alpha * t(c))).backward()
    scale = float(np.abs(want).max())
    assert np.abs(want[:, :6]).max() > 0.01 * scale
    np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=0,
                               atol=1e-4 * scale)


# ---------------------------------------------------------------------------
# the loop on the JAX package's draws, and the CLI
# ---------------------------------------------------------------------------


class JaxDraws:
    """The JAX package's draws, replaying ``_run``'s key schedule
    (iffnerf_tpu/inerf/estimate.py:155-157, 195-200): the initial (w, v,
    theta) from fold_in(key, 1..3), then per iteration a split into (key,
    sk, bk), ``batch`` indices of ``n`` without replacement from sk and a
    uniform colour from bk."""

    def __init__(self, seed, n, batch):
        self.key0 = self.key = jax.random.PRNGKey(seed)
        self.n, self.batch = n, batch

    def initial(self):
        parts = [1e-6 * jax.random.normal(jax.random.fold_in(self.key0, i),
                                          shape)
                 for i, shape in ((1, (3,)), (2, (3,)), (3, ()))]
        return torch.from_numpy(np.concatenate(
            [np.asarray(a).reshape(-1) for a in parts]))

    def step(self, k):
        self.key, sk, bk = jax.random.split(self.key, 3)
        idx = jax.random.choice(sk, self.n, (self.batch,), replace=False)
        bg = jax.random.uniform(bk, (3,))
        return (torch.from_numpy(np.asarray(idx).astype(np.int64)),
                torch.from_numpy(np.array(bg)))


def test_inerf_loop_matches_jax_with_its_draws(vm, frame, jax_loss,
                                               monkeypatch):
    """estimate_pose_inerf for 3 iterations (batch 64, dice, random
    background, random pixels) fed the JAX package's draws, against the
    JAX package's estimate_pose_inerf (its one jitted scan): the final
    loss and pose, the pose history, and each iteration's rgb loss
    against the JAX loss_fn at the pose JAX's history held before it.
    Adam's early steps are about lr x sign(grad) whatever the gradient's
    float32 rounding: 1e-5 absolute on the poses, rtol 1e-4 on the
    losses."""
    obs, cam_k, _, start = frame
    (jcfg, jp, jmask), (tcfg, tp, tmask) = vm
    kw = dict(sampling_strategy="random", lrate=0.02, batch_size=BATCH,
              color_bkgd_aug="random", n_iters=3, dice_loss=True, seed=5,
              return_history=True)
    jloss_last, jpose, jhist = jinerf.estimate_pose_inerf(
        start, obs, cam_k, jcfg, jp, jmask, **kw)
    kept = {}
    refine = tinerf.refine

    def keep(*args, **kwargs):
        kept["out"] = refine(*args, **kwargs)
        return kept["out"]

    monkeypatch.setattr(tinerf, "refine", keep)
    draws = JaxDraws(5, obs.shape[0] * obs.shape[1], BATCH)
    loss_last, pose, hist = tinerf.estimate_pose_inerf(
        start, obs, cam_k, tcfg, tp, tmask, draws=draws, device="cpu", **kw)
    np.testing.assert_allclose(hist, jhist, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pose, jpose, rtol=0, atol=1e-5)
    np.testing.assert_allclose(loss_last, jloss_last, rtol=1e-4)
    assert np.abs(jhist[-1] - start).max() > 1e-3  # the loop moved the pose

    replay = JaxDraws(5, obs.shape[0] * obs.shape[1], BATCH)
    p0 = replay.initial().numpy()
    poses = [jinerf.camera_transfer(p0[:3], p0[3:6], p0[6],
                                    jnp.asarray(start))] + list(jhist[:-1])
    cand = jinerf._build_candidates(obs, "random", 35, 1, BATCH)
    losses = kept["out"][0].numpy()
    assert losses.shape == (3,)
    for k, pose_k in enumerate(poses):
        idx, bg = replay.step(k)
        want, _ = jax_loss(jnp.asarray(pose_k), jnp.asarray(cand[idx.numpy()]),
                           jnp.asarray(bg.numpy()))
        np.testing.assert_allclose(losses[k], float(want), rtol=1e-4)


def test_pose_cli_inerf_dice_on_the_fixture(scene, vm, tmp_path, monkeypatch):
    """pose_cli --algorithm_type inerf_dice over one tensorf_<obj>_VM run
    (a field written by the JAX package; no ID training step, which
    test_pose_object.py's CLI tests cover): both test passes refine each of
    the 2 frames with estimate_pose_inerf on the run's field (cut to 2
    iterations), and the rows carry the refined poses."""
    monkeypatch.chdir(tmp_path)  # the trainer writes runs/
    calls = recorded_inerf(monkeypatch)
    run = tmp_path / "log" / "tensorf_lego_VM"
    run.mkdir(parents=True)
    save_field(str(run / "tensorf_lego_VM.npz"), *vm[0])
    rows = pose_cli.main([
        "--datadir", os.path.dirname(scene), "--exp_patch",
        str(tmp_path / "log"), "--out_path", str(tmp_path / "out.json"),
        "--gen_points", "32", "--id_backbone_depth", "1", "--id_iters", "0",
        "--device", "cpu",
        "--algorithm_type", "inerf_dice"])
    assert len(calls) == 4 and len(rows) == 2
    for args, kw, _ in calls:
        assert args[3] == vm[1][0]
        assert kw["n_iters"] == 800 and kw["dice_loss"]
    for row, (_, _, out) in zip(rows, calls[2:]):
        np.testing.assert_array_equal(row["pred_c2w"], out[1])
    with open(tmp_path / "out.json") as fh:
        assert len(json.load(fh)) == 2
