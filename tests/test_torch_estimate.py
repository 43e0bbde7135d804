"""Port parity for the whole slice: the banked and the unbanked (fused
scoring) single-image pose estimates against the JAX package's, with the
JAX Pallas kernel in interpret mode where the JAX route reaches it."""

import numpy as np
import jax.numpy as jnp
import pytest

from iffnerf_tpu.pose import id_module as jid
from iffnerf_tpu.pose import solve as jsolve
from iffnerf_tpu_torch.pose import id_module as tid
from iffnerf_tpu_torch.pose import solve as tsolve

from torch_parity import UP, configs, f32, params, replace, scene

K = 32


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    jp, tp = params(11, jcfg)
    return jcfg, tcfg, jp, tp, scene(11, 4096)


def _check(got, want):
    c2w, scores, idx, w = got
    c2w_w, scores_w, idx_w, w_w = (np.asarray(a) for a in want)
    # float32 scores to reduction order (tests/test_banked_pose.py),
    # the same top-k and the pose to 1e-4 (tests/test_fused_scoring.py)
    np.testing.assert_allclose(f32(scores), scores_w, rtol=2e-5, atol=2e-6)
    assert set(idx.tolist()) == set(idx_w.tolist())
    np.testing.assert_allclose(f32(w), w_w, rtol=2e-5, atol=2e-6)
    assert np.isfinite(f32(c2w)).all()
    np.testing.assert_allclose(f32(c2w), c2w_w, rtol=1e-4, atol=1e-4)


def test_banked_estimate_matches(setup):
    """Port: bank through the banked kernel's route (its plain version on
    the CPU); JAX: the exact banked path."""
    jcfg, tcfg, jp, tp, s = setup
    j = {k: jnp.asarray(v) for k, v in s.items()}
    jbank = jid.ray_bank(jp, jcfg, j["rays_ori"], j["rays_dirs"], j["rays_rgb"])
    want = jsolve.estimate_pose_single_banked(
        jp, jcfg, j["img"], j["mask"], jbank, j["rays_ori"], j["rays_dirs"],
        jnp.asarray(UP), k=K)
    bank = tid.ray_bank(tp, tcfg, s["rays_ori"], s["rays_dirs"],
                        s["rays_rgb"], device="cpu")
    got = tsolve.estimate_pose_single_banked(
        tp, tcfg, s["img"], s["mask"], bank, s["rays_ori"], s["rays_dirs"],
        UP, k=K, device="cpu")
    _check(got, want)


@pytest.mark.parametrize("n_rays", [4096, 1021])
def test_fused_estimate_matches(setup, n_rays):
    """fused_scoring=True on both sides: JAX through the Pallas kernel in
    interpret mode (4096 rays) or its XLA fallback (1021 rays, no tile
    divides it); the port through the fused kernel's route, which takes
    any ray count."""
    jcfg, tcfg, jp, tp, s = setup
    s = {k: v[:n_rays] if k.startswith("rays") else v for k, v in s.items()}
    j = {k: jnp.asarray(v) for k, v in s.items()}
    jcfg = replace(jcfg, fused_scoring=True)
    tcfg = replace(tcfg, fused_scoring=True)
    want = jsolve.estimate_pose_single(
        jp, jcfg, j["img"], j["mask"], j["rays_ori"], j["rays_dirs"],
        j["rays_rgb"], jnp.asarray(UP), k=K)
    got = tsolve.estimate_pose_single(
        tp, tcfg, s["img"], s["mask"], s["rays_ori"], s["rays_dirs"],
        s["rays_rgb"], UP, k=K, device="cpu")
    _check(got, want)


def test_unbanked_exact_estimate_matches_banked(setup):
    """The port's plain unbanked estimate and its banked estimate agree,
    as the JAX package's do."""
    _, tcfg, _, tp, s = setup
    a = tsolve.estimate_pose_single(
        tp, tcfg, s["img"], s["mask"], s["rays_ori"], s["rays_dirs"],
        s["rays_rgb"], UP, k=K, device="cpu")
    bank = tid.ray_bank(tp, tcfg, s["rays_ori"], s["rays_dirs"],
                        s["rays_rgb"], device="cpu")
    b = tsolve.estimate_pose_single_banked(
        tp, tcfg, s["img"], s["mask"], bank, s["rays_ori"], s["rays_dirs"],
        UP, k=K, device="cpu")
    _check(b, [x.numpy() for x in a])
