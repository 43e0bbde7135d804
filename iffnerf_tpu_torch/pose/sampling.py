"""Surface sampling + candidate-ray generation for IFFNeRF
(reference pose_estimation/sampling.py, model_utils.py:22-33).

The resampling loop follows the JAX package's fixed-budget form: every
iteration proposes 5 sphere jitters for all N samples, and an accepted
proposal overwrites only a still-invalid slot; the loop stops when every
slot was accepted or at ``max_iterations`` (one host sync per iteration).

Random draws come from explicit ``torch.Generator``s, made on the
generator's device. Each random step takes its draws as arguments
(``sampling_step``, ``samples_from_occupancy``), so a test can feed the
port the JAX package's draws.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from iffnerf_tpu_torch.device import resolve_device, tree_to
from iffnerf_tpu_torch.models.field import (
    AlphaMask,
    FieldConfig,
    compute_features,
    normalize_coord,
)
from iffnerf_tpu_torch.models.render import compute_alpha, render_rays
from iffnerf_tpu_torch.models.shading import compute_normals
from iffnerf_tpu_torch.pose.isocell import isocell_distribution, rotate_isocell


def _rand(gen, shape, dev):
    return torch.rand(shape, generator=gen, device=gen.device).to(dev)


def sphere_jitter(gen: torch.Generator, shape, rho: float, dev):
    """Uniform directions x |N(0, rho)| radii -> shape + (3,)
    (reference sampling.py:36-67)."""
    theta = 2 * math.pi * _rand(gen, shape, dev)
    phi = torch.arccos(1 - 2 * _rand(gen, shape, dev))
    dirs = torch.stack([torch.sin(phi) * torch.cos(theta),
                        torch.sin(phi) * torch.sin(theta),
                        torch.cos(phi)], dim=-1)
    radius = torch.randn(shape, generator=gen, device=gen.device).to(dev)
    return dirs * torch.abs(radius * rho)[..., None]


def generate_uniform_samples(gen, config: FieldConfig, n: int, dev):
    """(reference sampling.py:119-128)"""
    aabb = torch.as_tensor(config.aabb_np, device=dev)
    return _rand(gen, (n, 3), dev) * (aabb[1] - aabb[0]) + aabb[0]


def samples_from_occupancy(mask: AlphaMask, u: torch.Tensor,
                           jitter: torch.Tensor) -> torch.Tensor:
    """Points in occupied voxels: ``u`` [n] picks the (u+1)-th occupied
    voxel by inverse CDF over the occupancy prefix count, ``jitter`` [n, 3]
    in [0, 1) places the point inside it (reference sampling.py:79-116).
    An all-empty mask clamps every pick to the last voxel, in the grid."""
    vol = mask.volume  # [D, H, W] (z, y, x)
    d, h, w = vol.shape
    cdf = torch.cumsum((vol.reshape(-1) > 0).to(torch.int64), dim=0)
    flat_idx = torch.searchsorted(cdf, u.to(torch.int64), right=True)
    flat_idx = torch.clamp_max(flat_idx, d * h * w - 1)
    zi = flat_idx // (h * w)
    yi = (flat_idx // w) % h
    xi = flat_idx % w
    samples = torch.stack([xi, yi, zi], dim=-1).to(torch.float32) + jitter
    grid_shape = torch.tensor([w, h, d], dtype=torch.float32, device=vol.device)
    aabb_size = mask.aabb[1] - mask.aabb[0]
    return aabb_size * samples / (grid_shape - 1.0) + mask.aabb[0]


def generate_samples_from_occupancy_grid(gen, mask: AlphaMask, n: int):
    """Uniform choice over occupied voxels + in-voxel jitter."""
    dev = mask.volume.device
    total = max(int((mask.volume > 0).sum()), 1)
    u = torch.randint(0, total, (n,), generator=gen, device=gen.device).to(dev)
    return samples_from_occupancy(mask, u, _rand(gen, (n, 3), dev))


def generate_initial_samples(gen, config: FieldConfig, params,
                             mask: AlphaMask | None, n: int, dev):
    """(reference sampling.py:131-140)"""
    if mask is not None:
        samples = generate_samples_from_occupancy_grid(gen, mask, n)
    else:
        samples = generate_uniform_samples(gen, config, n, dev)
    return samples, compute_alpha(config, params, mask, samples, 1.0)


def sampling_step(config: FieldConfig, params, mask: AlphaMask | None,
                  samples, alpha, invalid, thresh, jitter, u):
    """One iteration of the resampling loop with its draws given: proposals
    ``samples + jitter`` [N, M, 3]; among each sample's proposals whose
    alpha exceeds ``thresh``, the one with the largest ``u`` [N, M] is
    picked, and it replaces the sample if that slot is still invalid.
    -> (samples, alpha, invalid)."""
    n, m = u.shape
    proposals = samples[:, None, :] + jitter
    alpha_new = compute_alpha(config, params, mask, proposals.reshape(-1, 3),
                              1.0).reshape(n, m)
    ok = alpha_new > thresh
    any_ok = torch.any(ok, dim=-1)
    # first maximum, as jnp.argmax
    pick = torch.argmax(torch.where(ok, u, -1.0), dim=-1)
    picked_samples = torch.take_along_dim(
        proposals, pick[:, None, None].expand(n, 1, 3), dim=1)[:, 0]
    picked_alpha = torch.take_along_dim(alpha_new, pick[:, None], dim=1)[:, 0]
    accept = invalid & any_ok
    samples = torch.where(accept[:, None], picked_samples, samples)
    alpha = torch.where(accept, picked_alpha, alpha)
    return samples, alpha, invalid & ~any_ok


def sampling_epoch(gen, config: FieldConfig, params, mask: AlphaMask | None,
                   samples, alpha, rho: float, max_iterations: int = 200,
                   n_multiple: int = 5):
    """One Metropolis-like resampling epoch (reference sampling.py:144-213)
    -> (samples, alpha, iterations, samples still invalid)."""
    # linear interpolation between order statistics, as jnp.quantile
    thresh = torch.quantile(alpha, 0.6)
    n = samples.shape[0]
    invalid = torch.ones(n, dtype=torch.bool, device=samples.device)
    it = 0
    while it < max_iterations and bool(invalid.any()):
        jitter = sphere_jitter(gen, (n, n_multiple), rho, samples.device)
        u = _rand(gen, (n, n_multiple), samples.device)
        samples, alpha, invalid = sampling_step(
            config, params, mask, samples, alpha, invalid, thresh, jitter, u)
        it += 1
    return samples, alpha, it, int(invalid.sum())


def _on_device(params, mask, device):
    dev = resolve_device(device)
    if mask is not None:
        mask = AlphaMask(mask.volume.to(dev), mask.aabb.to(dev),
                         mask.unisphere)
    return tree_to(params, dev), mask, dev


@torch.no_grad()
def iterative_surface_sampling_process(gen, config: FieldConfig, params,
                                       mask: AlphaMask | None,
                                       gen_points: int = 8000,
                                       n_iteration: int = 4,
                                       max_resampling_iterations: int = 200,
                                       device=None):
    """Surface samples [gen_points, 3] (reference sampling.py:509-532) on
    ``device`` (CUDA unless ``device="cpu"``) -> (samples, one pair a
    epoch: the loop's iteration count, the samples left invalid at its
    end)."""
    params, mask, dev = _on_device(params, mask, device)
    samples, alpha = generate_initial_samples(gen, config, params, mask,
                                              gen_points, dev)
    grid_size = np.asarray(config.grid_size, np.float32)
    if mask is not None:
        rho = float(np.max(grid_size) * 0.1
                    * np.max(config.aabb_size / grid_size))
    else:
        rho = float(np.linalg.norm(config.aabb_size))
    epochs = []
    for _ in range(n_iteration):
        samples, alpha, it, n_invalid = sampling_epoch(
            gen, config, params, mask, samples, alpha, rho,
            max_iterations=max_resampling_iterations)
        epochs.append((it, n_invalid))
    return samples, epochs


@torch.no_grad()
def samples_points_normals(config: FieldConfig, params, samples):
    """Surface normals from the frozen field's Ref head
    (reference sampling.py:535-541)."""
    _, app_features = compute_features(
        config, params, normalize_coord(config, samples), with_density=False)
    return compute_normals(params["shading"], config.shading_mode,
                           app_features)


@torch.no_grad()
def evaluate_viewdirs_color(config: FieldConfig, params, mask, points,
                            viewdirs, white_bg: bool = False):
    """Ray colour by rendering 20 samples centred on the surface point
    (reference sampling.py:237-251; tensorBase.py:623-638)."""
    rays = torch.cat([points.expand_as(viewdirs), viewdirs],
                     dim=-1).reshape(-1, 6)
    rgb, *_ = render_rays(config, params, mask, rays, white_bg=white_bg,
                          sample_mode="point_color", n_samples=20)
    return rgb.reshape(viewdirs.shape)


@torch.no_grad()
def generate_all_possible_rays(config: FieldConfig, params,
                               mask: AlphaMask | None, points, normals,
                               num_viewdirs_per_chunk: int = 10240,
                               sample_isocell_targets: int = 27):
    """points x isocell dirs -> (ori, dirs, rgb), each [N*M, 3], coloured
    in chunks of ``num_viewdirs_per_chunk // M`` points
    (reference sampling.py:442-488)."""
    sample_dirs = torch.as_tensor(
        isocell_distribution(sample_isocell_targets, N0=3, isrand=-1),
        device=points.device)
    rotated = rotate_isocell(sample_dirs, normals)  # [N, M, 3]
    rotated = rotated / torch.linalg.norm(rotated, dim=-1, keepdim=True)
    points_b = points[:, None].expand_as(rotated)
    per_chunk = max(num_viewdirs_per_chunk // sample_dirs.shape[0], 1)
    rgbs = torch.cat([
        evaluate_viewdirs_color(config, params, mask,
                                points_b[i:i + per_chunk],
                                rotated[i:i + per_chunk])
        for i in range(0, points.shape[0], per_chunk)])
    return (points_b.reshape(-1, 3), rotated.reshape(-1, 3),
            rgbs.reshape(-1, 3))


def explore_field(gen, config: FieldConfig, params, mask: AlphaMask | None,
                  gen_points: int = 20000, device=None, **kwargs):
    """The candidate-ray-set generator (reference model_utils.py:22-33):
    surface points -> normals -> isocell rays -> per-ray colours, on
    ``device`` (CUDA unless ``device="cpu"``). ``kwargs`` go to
    ``iterative_surface_sampling_process``."""
    params, mask, dev = _on_device(params, mask, device)
    samples, _ = iterative_surface_sampling_process(
        gen, config, params, mask, gen_points=gen_points, device=dev,
        **kwargs)
    normals = samples_points_normals(config, params, samples)
    return generate_all_possible_rays(config, params, mask, samples, normals)
