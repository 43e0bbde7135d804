"""iNeRF: iterative photometric pose refinement against a frozen field
(reference inerf/estimate_pose_inerf.py:23-195, inerf/inerf.py:39-104,
inerf/dice_loss.py:8-75; the JAX package's ``iffnerf_tpu/inerf/estimate.py``).

The JAX package runs the whole optimization as one ``lax.scan`` in one
jit. Here it is a Python loop of eager torch on the device: each iteration
draws its pixels and background, builds the rays from the current se(3)
pose, renders them with grad (on the card a TensorVMSplit field's sample
points reach ``field_features``' coordinate-gradient kernel), takes the
loss and its gradient in (w, v, theta), and steps Adam. Nothing in the
loop waits for the device: the losses and the pose history stay there
until the loop ends. The SIFT point-of-interest detection (cv2) runs on
the host before it.

Random draws come from a ``torch.Generator`` seeded by ``seed``
(``GeneratorDraws``) in place of the JAX package's key; the loop takes
them from the ``draws`` object it is given, so that a parity test can hand
it the JAX package's draws.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from iffnerf_tpu_torch.data.rays_np import ray_directions_Ks_np
from iffnerf_tpu_torch.device import as_tensor, resolve_device, tree_to
from iffnerf_tpu_torch.models.field import AlphaMask, FieldConfig
from iffnerf_tpu_torch.models.render import render_rays
from iffnerf_tpu_torch.pose.isocell import vec2ss_matrix

# Adam as the JAX package's optax.adam (b1, b2, eps; eps_root 0)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
# the learning rate decays 0.8^(k/100)
# (reference estimate_pose_inerf.py:185-187)
LR_DECAY_RATE, LR_DECAY_STEPS = 0.8, 100


def find_poi(img_rgb: np.ndarray) -> np.ndarray:
    """SIFT keypoints (host-side, cv2; reference inerf/inerf.py:39-49).
    Returns unique integer xy coordinates [N, 2]."""
    import cv2

    gray = (cv2.cvtColor(img_rgb, cv2.COLOR_RGB2GRAY) * 255.0).astype(
        np.uint8
    )
    keypoints = cv2.SIFT_create().detect(gray, None)
    if not keypoints:
        return np.zeros((0, 2), dtype=np.int64)
    xy = np.array([kp.pt for kp in keypoints]).astype(np.int64)
    return np.unique(xy, axis=0)


def camera_transfer(w, v, theta, start_pose):
    """Exponential-map pose update (reference CameraTransfer,
    inerf/inerf.py:64-91): T = exp([w]θ-style Rodrigues, V(θ)v) @ start."""
    wss = vec2ss_matrix(w)
    wss2 = wss @ wss
    eye = torch.eye(3, dtype=start_pose.dtype, device=start_pose.device)
    rot = eye + torch.sin(theta) * wss + (1.0 - torch.cos(theta)) * wss2
    trans = (
        eye * theta + (1.0 - torch.cos(theta)) * wss
        + (theta - torch.sin(theta)) * wss2
    ) @ v
    last = torch.zeros((1, 4), dtype=start_pose.dtype,
                       device=start_pose.device)
    last[0, 3] = 1.0
    exp_i = torch.cat([torch.cat([rot, trans[:, None]], dim=1), last], dim=0)
    return exp_i @ start_pose


def soft_dice_loss(probs_logits, labels, p: float = 1.0, smooth: float = 1.0):
    """Soft-Dice on sigmoid(logits) (reference inerf/dice_loss.py:34-57;
    autodiff replaces its hand-written backward)."""
    probs = torch.sigmoid(probs_logits.reshape(-1))
    labels = labels.reshape(-1)
    numer = 2.0 * torch.sum(probs * labels) + smooth
    denor = torch.sum(probs ** p + labels ** p) + smooth
    return 1.0 - numer / denor


def _build_candidates(obs_img: np.ndarray, sampling_strategy: str,
                      kernel_size: int, dil_iter: int, batch_size: int):
    """Host-side pixel-candidate set per strategy
    (reference estimate_pose_inerf.py:44-132)."""
    h, w = obs_img.shape[:2]
    coords = np.stack(
        np.meshgrid(np.arange(w), np.arange(h)), -1
    ).astype(np.int64)  # [H, W, 2] (x, y)

    if sampling_strategy == "random":
        return coords.reshape(-1, 2)
    poi = find_poi(obs_img[..., :3].astype(np.float32))
    if sampling_strategy == "interest_points":
        if poi.shape[0] >= batch_size:
            return poi
        # pad with non-POI pixels like the reference (:119-124)
        mask = np.ones((h, w), bool)
        if poi.shape[0]:
            mask[poi[:, 1], poi[:, 0]] = False
        rest = coords[mask]
        return np.concatenate([poi, rest], axis=0)
    if sampling_strategy == "interest_regions":
        import cv2

        regions = np.zeros((h, w), np.uint8)
        if poi.shape[0]:
            regions[poi[:, 1], poi[:, 0]] = 1
        regions = cv2.dilate(
            regions, np.ones((kernel_size, kernel_size), np.uint8),
            iterations=dil_iter,
        ).astype(bool)
        cand = coords[regions]
        return cand if cand.shape[0] else coords.reshape(-1, 2)
    raise ValueError(f"Unknown sampling strategy {sampling_strategy}")


def learning_rate(lrate: float, k: int) -> float:
    """Adam's step size at iteration k (from 0): optax's
    ``exponential_decay(lrate, 100, 0.8)``, not staircase."""
    return lrate * LR_DECAY_RATE ** (k / LR_DECAY_STEPS)


class GeneratorDraws:
    """The loop's random draws, from a ``torch.Generator`` seeded by
    ``seed`` on ``device``: ``initial()`` the starting (w, v, theta) packed
    as [7], 1e-6 N(0, 1); ``step(k)`` iteration k's ``batch_size`` indices
    into ``n`` candidates, without replacement, and a uniform colour [3]
    (the background when it is random)."""

    def __init__(self, seed: int, n: int, batch_size: int, device):
        if batch_size > n:
            raise ValueError(f"cannot draw {batch_size} of {n} candidate "
                             f"pixels without replacement")
        self.n, self.batch_size, self.device = n, batch_size, device
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def initial(self) -> torch.Tensor:
        return 1e-6 * torch.randn(7, generator=self.gen, device=self.device)

    def step(self, k: int):
        idx = torch.randperm(self.n, generator=self.gen,
                             device=self.device)[:self.batch_size]
        return idx, torch.rand(3, generator=self.gen, device=self.device)


def _pose(p, start_pose):
    """c2w [4, 4] of the packed pose parameters p [7] = (w, v, theta)."""
    return camera_transfer(p[:3], p[3:6], p[6], start_pose)


def _loss(config, params, mask, p, start_pose, obs, dirs_norm, radii_cam,
          batch_xy, bg_color, dice_loss):
    """(total loss, rgb loss) of one batch of pixels at the pose of p (the
    JAX package's ``loss_fn``)."""
    pose = _pose(p, start_pose)
    bx, by = batch_xy[:, 0], batch_xy[:, 1]
    d_cam = dirs_norm[by, bx]
    rays_d = d_cam @ pose[:3, :3].T
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rays_o = pose[:3, 3].expand(rays_d.shape)
    rays = torch.cat([rays_o, rays_d, radii_cam[by, bx]], dim=-1)

    target = obs[by, bx]
    rgb_t, alpha_t = target[:, :3], target[:, 3:]
    target_rgb = rgb_t * alpha_t + bg_color * (1.0 - alpha_t)

    rgb, _, acc, _, _, _ = render_rays(config, params, mask, rays,
                                       is_train=False, bg_color=bg_color)
    rgb_loss = torch.mean(torch.square(rgb - target_rgb))
    total = rgb_loss
    if dice_loss:
        # the clipped opacity goes to sigmoid as logits, as in the JAX package
        op = torch.clamp(acc, 1e-3, 1.0 - 1e-3)
        total = total + soft_dice_loss(op[:, None], alpha_t)
    return total, rgb_loss


def refine(config: FieldConfig, params, mask: AlphaMask | None, start_pose,
           obs, cand, dirs_norm, radii_cam, draws, *, lrate: float,
           n_iters: int, color_bkgd_aug: str, dice_loss: bool):
    """The iNeRF loop (the JAX package's ``_run``): ``n_iters`` Adam steps
    on (w, v, theta) from ``draws.initial()``, iteration k at the learning
    rate ``learning_rate(lrate, k)`` on the pixels ``cand[idx]`` and the
    background of ``draws.step(k)``. Tensors on one device: start_pose [4,
    4], obs [H, W, 4], cand [C, 2] int64 (x, y), dirs_norm [H, W, 3],
    radii_cam [H, W, 1]. -> (rgb loss of each iteration [n_iters], refined
    c2w [4, 4], the pose after each iteration [n_iters, 4, 4]), on the
    device; no host sync."""
    if n_iters < 1:
        raise ValueError(f"n_iters must be at least 1, got {n_iters}")
    dev = obs.device
    fixed_bg = None  # "random": the colour of each iteration's draws
    if color_bkgd_aug == "white":
        fixed_bg = torch.ones(3, device=dev)
    elif color_bkgd_aug != "random":
        fixed_bg = torch.zeros(3, device=dev)
    p = draws.initial().to(device=dev, dtype=torch.float32)
    mu, nu = torch.zeros_like(p), torch.zeros_like(p)
    losses, poses = [], []
    for k in range(n_iters):
        idx, colour = draws.step(k)
        bg = colour if fixed_bg is None else fixed_bg
        with torch.enable_grad():
            leaf = p.detach().requires_grad_()
            total, rgb_loss = _loss(config, params, mask, leaf, start_pose,
                                    obs, dirs_norm, radii_cam, cand[idx], bg,
                                    dice_loss)
            (grad,) = torch.autograd.grad(total, leaf)
        with torch.no_grad():
            mu = (1.0 - ADAM_B1) * grad + ADAM_B1 * mu
            nu = (1.0 - ADAM_B2) * grad * grad + ADAM_B2 * nu
            mu_hat = mu / (1.0 - ADAM_B1 ** (k + 1))
            nu_hat = nu / (1.0 - ADAM_B2 ** (k + 1))
            p = p - learning_rate(lrate, k) * (mu_hat / (torch.sqrt(nu_hat)
                                                         + ADAM_EPS))
            losses.append(rgb_loss.detach())
            poses.append(_pose(p, start_pose))
    return torch.stack(losses), _pose(p, start_pose), torch.stack(poses)


def ray_grids(h: int, w: int, cam_k):
    """The camera's unit ray directions [H, W, 3] and mip radii [H, W, 1]
    (numpy float32) from the intrinsics K [3, 3], as the JAX package's loop
    builds them from ``get_ray_directions_Ks``."""
    k = np.asarray(cam_k, np.float32).reshape(1, 3, 3)
    ori, dx, dy = (a[0] for a in ray_directions_Ks_np(h, w, k))
    dirs_norm = ori / np.linalg.norm(ori, axis=-1, keepdims=True)
    dxn = np.linalg.norm(dx - ori, axis=-1)
    dyn = np.linalg.norm(dy - ori, axis=-1)
    radii = (0.5 * (dxn + dyn))[..., None] * np.float32(2.0 / np.sqrt(12.0))
    return dirs_norm, radii.astype(np.float32)


def loop_inputs(obs_img, cam_k, device, sampling_strategy: str = "random",
                kernel_size: int = 35, dil_iter: int = 1,
                batch_size: int = 1024):
    """What the loop reads, on ``device``: (obs [H, W, 4] float32, pixel
    candidates [C, 2] int64 (x, y), unit camera directions [H, W, 3], mip
    radii [H, W, 1]) from the RGBA observation (numpy or a tensor) and the
    intrinsics K [3, 3]."""
    obs = as_tensor(obs_img, device, torch.float32)
    h, w = obs.shape[:2]
    # the random strategy reads only the image's size; SIFT reads its pixels
    candidates = _build_candidates(
        obs if sampling_strategy == "random" else obs.cpu().numpy(),
        sampling_strategy, kernel_size, dil_iter, batch_size)
    dirs_norm, radii_cam = ray_grids(h, w, cam_k)
    return (obs, torch.as_tensor(candidates, device=device),
            torch.as_tensor(dirs_norm, device=device),
            torch.as_tensor(radii_cam, device=device))


def estimate_pose_inerf(start_pose, obs_img, cam_k, config: FieldConfig,
                        params, mask: AlphaMask | None,
                        sampling_strategy: str = "interest_regions",
                        lrate: float = 0.02, batch_size: int = 1024,
                        kernel_size: int = 35, dil_iter: int = 1,
                        color_bkgd_aug: str = "random", n_iters: int = 1000,
                        dice_loss: bool = False, seed: int = 0,
                        return_history: bool = False, draws=None,
                        device=None):
    """Returns (final_rgb_loss, refined c2w [4,4], pose history [n,4,4] |
    None), numpy, as the JAX package's ``estimate_pose_inerf``.

    obs_img is [H, W, 4] RGBA in [0,1] (alpha = object mask), numpy or a
    tensor. The loop runs on ``device`` (CUDA unless ``device="cpu"``)
    under grad, the field frozen; its draws come from
    ``GeneratorDraws(seed, ...)`` unless ``draws`` is given."""
    dev = resolve_device(device)
    obs, cand, dirs_norm, radii_cam = loop_inputs(
        obs_img, cam_k, dev, sampling_strategy, kernel_size, dil_iter,
        batch_size)
    params = tree_to(params, dev)
    if mask is not None:
        mask = dataclasses.replace(mask, volume=mask.volume.to(dev),
                                   aabb=mask.aabb.to(dev))
    if draws is None:
        draws = GeneratorDraws(seed, cand.shape[0], batch_size, dev)
    losses, pose, history = refine(
        config, params, mask, as_tensor(start_pose, dev, torch.float32), obs,
        cand, dirs_norm, radii_cam, draws, lrate=float(lrate),
        n_iters=n_iters, color_bkgd_aug=color_bkgd_aug, dice_loss=dice_loss)
    history = history.cpu().numpy() if return_history else None
    return float(losses[-1]), pose.cpu().numpy(), history
