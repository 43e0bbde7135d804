"""Volume-rendering forward pass, dense (reference
models/tensorBase.py:494-536, :623-638, :698-917).

As in the JAX package, the reference's boolean-mask gathers become masked
dense compute: every sample's density and appearance is evaluated and
invalid ones are zeroed. The AABB sampler takes the training jitter, one
uniform draw a ray from a ``torch.Generator`` or handed in as ``jitter``;
the point-colour sampler is the pose pipeline's. The NDC sampler of
forward-facing scenes takes one uniform draw a sample, from a
``torch.Generator`` or handed in as ``jitter``. Infinity and unisphere
sampling are not ported and raise.
"""

from __future__ import annotations

import torch

from iffnerf_tpu_torch.models.field import (
    AlphaMask,
    FieldConfig,
    compute_features,
    feature2density,
    normalize_coord,
    sample_alpha,
)
from iffnerf_tpu_torch.models.shading import apply_shading
from iffnerf_tpu_torch.ops.ray_march import raw2alpha


def _aabb(config: FieldConfig, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(config.aabb_np, device=like.device)


def _aabb_t_range(aabb, rays_o, rays_d):
    """Entry/exit t of each ray w.r.t. the AABB (slab test)."""
    vec = torch.where(rays_d == 0, 1e-6, rays_d)
    rate_a = (aabb[1] - rays_o) / vec
    rate_b = (aabb[0] - rays_o) / vec
    t_min = torch.amax(torch.minimum(rate_a, rate_b), dim=-1)
    t_max = torch.amin(torch.maximum(rate_a, rate_b), dim=-1)
    return t_min, t_max


def _in_aabb(aabb, xyz):
    return ~torch.any((aabb[0] > xyz) | (xyz > aabb[1]), dim=-1)


def sample_ray(config: FieldConfig, rays_o, rays_d, *, gen=None,
               jitter=None, is_train: bool = True, n_samples: int = -1):
    """Equidistant samples from the AABB entry point, jittered in training
    by one uniform draw a ray (reference sample_ray, tensorBase.py:494-536).
    The draw is ``jitter`` [N, 1] when given, else ``torch.rand`` from
    ``gen``; ``is_train`` needs one of them.

    Returns (xyz [N, S, 3], z_vals [N, S], valid [N, S])."""
    if config.contraction_type == "unisphere":
        raise NotImplementedError("unisphere sampling is not ported")
    n = n_samples if n_samples > 0 else config.n_samples
    near, far = config.near_far
    aabb = _aabb(config, rays_o)
    t_min, _ = _aabb_t_range(aabb, rays_o, rays_d)
    t_min = torch.clamp(t_min, near, far)
    total = n + config.n_samples_bg
    rng = torch.arange(total, dtype=rays_o.dtype, device=rays_o.device)[None, :]
    if is_train:
        if jitter is None:
            if gen is None:
                raise ValueError("training sampling needs a generator or a "
                                 "jitter draw")
            jitter = torch.rand((rays_o.shape[0], 1), generator=gen,
                                device=gen.device)
        rng = rng + jitter.to(device=rays_o.device, dtype=rays_o.dtype)
    z_vals = t_min[:, None] + config.step_size * rng
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    return xyz, z_vals, _in_aabb(aabb, xyz)


def _linspace(start: float, stop: float, n: int, like: torch.Tensor):
    """jnp.linspace's float32 arithmetic, bit for bit: start * (1 - f) +
    stop * f with f = i times the float32 reciprocal of n - 1, and the
    last value stop itself."""
    if n < 2:
        return torch.full((n,), start, dtype=like.dtype, device=like.device)
    recip = torch.tensor(1.0 / (n - 1), dtype=like.dtype).item()
    frac = torch.arange(n - 1, dtype=like.dtype, device=like.device) * recip
    head = start * (1 - frac) + stop * frac
    return torch.cat([head, torch.full((1,), stop, dtype=like.dtype,
                                       device=like.device)])


def sample_ray_ndc(config: FieldConfig, rays_o, rays_d, *, gen=None,
                   jitter=None, is_train: bool = True, n_samples: int = -1):
    """Samples linear in NDC depth over [near, far], jittered in training by
    one uniform draw a sample (reference sample_ray_ndc,
    tensorBase.py:460-471). The draw is ``jitter`` [N, n] when given, else
    ``torch.rand`` from ``gen``; ``is_train`` needs one of them.

    Returns (xyz [N, n, 3], z_vals [N, n], valid [N, n])."""
    n = n_samples if n_samples > 0 else config.n_samples
    near, far = config.near_far
    aabb = _aabb(config, rays_o)
    interpx = _linspace(near, far, n, rays_o)[None, :]
    if is_train:
        if jitter is None:
            if gen is None:
                raise ValueError("training sampling needs a generator or a "
                                 "jitter draw")
            jitter = torch.rand((rays_o.shape[0], n), generator=gen,
                                device=gen.device)
        interpx = interpx + jitter.to(device=rays_o.device,
                                      dtype=rays_o.dtype) * ((far - near) / n)
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * interpx[..., None]
    return xyz, interpx.expand(rays_o.shape[0], n), _in_aabb(aabb, xyz)


def sample_point_color_fn(config: FieldConfig, rays_o, rays_d,
                          n_samples: int = 20):
    """Samples centred on the ray origin (a surface point): +-N/2 steps
    (reference sample_point_color, tensorBase.py:623-638)."""
    before = n_samples // 2
    after = n_samples - before
    aabb = _aabb(config, rays_o)
    rng = torch.arange(-before, after, dtype=rays_o.dtype,
                       device=rays_o.device)[None, :]
    step = config.step_size * rng
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * step[..., None]
    return xyz, step, _in_aabb(aabb, xyz)


def compute_alpha(config: FieldConfig, params, mask: AlphaMask | None,
                  xyz: torch.Tensor, length) -> torch.Tensor:
    """Opacity of points xyz [..., 3] over a step ``length``
    (reference compute_alpha, tensorBase.py:756-773)."""
    feature, _ = compute_features(config, params, normalize_coord(config, xyz),
                                  with_app=False)
    sigma = feature2density(config, feature)
    if mask is not None:
        sigma = torch.where(sample_alpha(mask, xyz) > 0, sigma, 0.0)
    return 1.0 - torch.exp(-sigma * length)


def render_rays(config: FieldConfig, params, mask: AlphaMask | None,
                rays_chunk: torch.Tensor, *, gen=None, jitter=None,
                white_bg: bool = False, bg_color=None, is_train: bool = False,
                ndc_ray: bool = False, sample_mode: str = "aabb",
                n_samples: int = -1):
    """Volumetric forward (reference TensorBase.forward,
    tensorBase.py:775-917), differentiable in ``params`` and in
    ``rays_chunk`` (the sample points, the z values through the AABB entry
    and the view directions carry the gradient; iNeRF's pose gradient):

      * appearance features are accumulated along the ray first and the
        shading head runs once per ray on the accumulated feature;
      * appearance only where ``weight > rayMarch_weight_thres``;
      * depth = sum(w*z) + (1-acc) * rays_chunk[..., -1];
      * rgb composited as rgb*acc + bg*(1-acc), clipped.

    ``sample_mode`` is "aabb", "point_color" or "ndc" (``ndc_ray`` too:
    samples linear in NDC depth, ``dists`` scaled by the direction's norm
    and the view directions normalised); rays_chunk is [N, 6|7] (ori, dir,
    optional mip radius). ``is_train`` jitters the AABB or NDC samples
    (``sample_ray``'s or ``sample_ray_ndc``'s ``gen`` or ``jitter``: [N, 1]
    for the AABB, [N, n] for NDC). The alpha-mask lookup is a
    boolean test on detached points, and the depth carries no gradient, as
    in the JAX package. Returns (rgb [N,3], depth [N], acc [N],
    alpha [N,S], z_vals [N,S], dists [N,S])."""
    ndc = ndc_ray or sample_mode == "ndc"
    rays_o = rays_chunk[:, :3]
    viewdirs = rays_chunk[:, 3:6]
    if sample_mode == "point_color":
        xyz, z_vals, ray_valid = sample_point_color_fn(
            config, rays_o, viewdirs,
            n_samples=n_samples if n_samples > 0 else 20)
    elif ndc:
        xyz, z_vals, ray_valid = sample_ray_ndc(
            config, rays_o, viewdirs, gen=gen, jitter=jitter,
            is_train=is_train, n_samples=n_samples)
    elif sample_mode == "aabb":
        xyz, z_vals, ray_valid = sample_ray(
            config, rays_o, viewdirs, gen=gen, jitter=jitter,
            is_train=is_train, n_samples=n_samples)
    else:
        raise NotImplementedError(f"sample_mode {sample_mode!r} is not ported")

    dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                       torch.zeros_like(z_vals[:, :1])], dim=-1)
    if ndc:
        rays_norm = torch.linalg.vector_norm(viewdirs, dim=-1, keepdim=True)
        dists = dists * rays_norm
        viewdirs = viewdirs / rays_norm
    if mask is not None:
        ray_valid = ray_valid & (sample_alpha(mask, xyz.detach()) > 0)

    sigma_feature, app_features = compute_features(
        config, params, normalize_coord(config, xyz))
    sigma = torch.where(ray_valid, feature2density(config, sigma_feature), 0.0)
    alpha, weight, _ = raw2alpha(sigma, dists * config.distance_scale)

    app_mask = weight > config.ray_march_weight_thres
    app_features = torch.where(app_mask[..., None], app_features, 0.0)
    acc_map = torch.sum(weight, dim=-1)
    cum_app_features = torch.sum(weight[..., None] * app_features, dim=-2)
    rays_to_consider = torch.any(app_mask, dim=-1)

    rgb, _ = apply_shading(
        params["shading"], config.shading_mode, None, viewdirs,
        cum_app_features, view_pe=config.view_pe, pos_pe=config.pos_pe,
        fea_pe=config.fea_pe)
    rgb_map = torch.where(rays_to_consider[..., None], rgb, 0.0)
    if bg_color is None:
        bg_color = 1.0 if white_bg else 0.0
    rgb_map = rgb_map * acc_map[..., None] + bg_color * (1.0 - acc_map[..., None])
    rgb_map = torch.clamp(rgb_map, 0.0, 1.0)

    depth_map = (torch.sum(weight * z_vals, dim=-1)
                 + (1.0 - acc_map) * rays_chunk[..., -1]).detach()
    return rgb_map, depth_map, acc_map, alpha, z_vals, dists


def filtering_rays_bbox(config: FieldConfig, rays: torch.Tensor) -> torch.Tensor:
    """Per-ray AABB hit mask (reference filtering_rays bbox_only branch,
    tensorBase.py:718-728)."""
    aabb = _aabb(config, rays)
    t_min, t_max = _aabb_t_range(aabb, rays[..., :3], rays[..., 3:6])
    return t_max > t_min
