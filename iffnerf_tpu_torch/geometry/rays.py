"""Camera-ray generation with mip-NeRF radii, NDC warping, hierarchical PDF
sampling: the JAX package's ``geometry/rays.py`` in torch.

The reference geometry layer:
  * root ray_utils.py:8-159 (K-based directions + dx/dy neighbour grids,
    world rays + mip radii, parameterised ray generation),
  * dataLoader/ray_utils.py:29-123,155-291 (focal-based directions in the
    OpenCV and Blender conventions, simple world rays, NDC, sample_pdf,
    the ray marcher, the PFM reader).

Each function runs on the device of its tensor arguments (the pixel grids
on ``device``, the CPU by default, where a function takes no tensor).
Random draws come from a ``torch.Generator`` in place of the JAX
package's key, or are passed in whole (``u`` of ``sample_pdf``, ``noise``
of ``ray_marcher``), so that two packages can be fed the same draws.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def cast_rays(ori, dirs, z_vals):
    """(reference ray_utils.py:8-9)"""
    return ori[..., None, :] + z_vals[..., None] * dirs[..., None, :]


def _pixel_grid(H: int, W: int, pixel_center: float, dtype=torch.float32,
                device=None):
    i = torch.arange(W, dtype=dtype, device=device) + pixel_center
    j = torch.arange(H, dtype=dtype, device=device) + pixel_center
    return torch.meshgrid(i, j, indexing="xy")  # each [H, W]


def get_ray_directions(H: int, W: int, focal, center=None,
                       use_pixel_centers: bool = True, device=None):
    """OpenCV-convention camera dirs (+x right, +y down, +z forward)
    (reference dataLoader/ray_utils.py:29-49; grid always pixel-centred)."""
    i, j = _pixel_grid(H, W, 0.5 if use_pixel_centers else 0.0, device=device)
    cx, cy = center if center is not None else (W / 2, H / 2)
    return torch.stack([(i - cx) / focal[0], (j - cy) / focal[1],
                        torch.ones_like(i)], dim=-1)


def get_ray_directions_blender(H: int, W: int, focal, center=None,
                               use_pixel_centers: bool = True, device=None):
    """Blender-convention camera dirs (+x right, -y down, -z forward)
    (reference dataLoader/ray_utils.py:52-71)."""
    i, j = _pixel_grid(H, W, 0.5 if use_pixel_centers else 0.0, device=device)
    cx, cy = center if center is not None else (W / 2, H / 2)
    return torch.stack([(i - cx) / focal[0], -(j - cy) / focal[1],
                        -torch.ones_like(i)], dim=-1)


def get_ray_directions_Ks(H: int, W: int, K, use_pixel_centers: bool = True):
    """Directions from intrinsics K [B, 3, 3], plus +1-pixel neighbour
    directions for mip radii (reference ray_utils.py:28-58).

    Returns (directions, dx, dy), each [B, H, W, 3]."""
    K = torch.as_tensor(K)
    pc = 0.5 if use_pixel_centers else 0.0
    i, j = _pixel_grid(H, W, pc, dtype=K.dtype, device=K.device)
    base = torch.stack([i, j], dim=-1)  # [H, W, 2]
    base_dx = base.clone()
    base_dx[..., 0] += 1.0
    base_dy = base.clone()
    base_dy[..., 1] += 1.0
    stacked = torch.stack([base, base_dx, base_dy])  # [3, H, W, 2]
    coords = torch.cat([stacked, torch.ones_like(stacked[..., :1])], -1)
    inv_k = torch.linalg.inv(K)  # [B, 3, 3]
    dirs = torch.einsum("bij,ghwj->bghwi", inv_k, coords)
    return dirs[:, 0], dirs[:, 1], dirs[:, 2]


def get_rays(viewdirs, c2w, keepdim: bool = False, directions=None,
             dx=None, dy=None):
    """Camera dirs -> world rays (+ mip-NeRF radii when dx/dy given)
    (reference ray_utils.py:61-100). c2w is [..., 3|4, 4]."""
    assert viewdirs.shape[-1] == 3
    assert (dx is None) == (dy is None)
    rot = c2w[..., :3, :3]

    rays_d = torch.sum(viewdirs[..., None, :] * rot, dim=-1)
    if dx is not None:
        dx = torch.sum(dx[..., None, :] * rot, dim=-1)
        dy = torch.sum(dy[..., None, :] * rot, dim=-1)
    if directions is not None:
        directions = torch.sum(directions[..., None, :] * rot, dim=-1)
    else:
        directions = rays_d

    rays_o = torch.broadcast_to(c2w[..., :3, 3][..., None, :], rays_d.shape)

    if not keepdim:
        rays_o = rays_o.reshape(-1, 3)
        rays_d = rays_d.reshape(-1, 3)
        directions = directions.reshape(-1, 3)
        if dx is not None:
            dx = dx.reshape(-1, 3)
            dy = dy.reshape(-1, 3)

    if dx is not None:
        dx_norm = torch.linalg.norm(dx - directions, dim=-1)
        dy_norm = torch.linalg.norm(dy - directions, dim=-1)
        # half-pixel distance scaled to the stddev of a pixel-wide uniform
        # distribution (2/sqrt(12); mip-NeRF) -- reference ray_utils.py:93-97
        radii = (0.5 * (dx_norm + dy_norm))[..., None] * (2.0 / math.sqrt(12.0))
        return rays_o, rays_d, radii
    return rays_o, rays_d


def get_rays_lie(viewdirs, rotation, translation, keepdim: bool = False,
                 directions=None, dx=None, dy=None):
    """SE(3)-parameterised ray generation (reference ray_utils.py:103-145;
    kornia's ``Se3`` argument is an explicit rotation [..., 3, 3] and
    translation [..., 3] here). Differentiable in both. Same output
    convention as ``get_rays``."""
    assert viewdirs.shape[-1] == 3
    c2w = torch.cat([rotation, translation[..., :, None]], dim=-1)
    pad = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=c2w.dtype,
                       device=c2w.device).expand(c2w.shape[:-2] + (1, 4))
    return get_rays(viewdirs, torch.cat([c2w, pad], dim=-2),
                    keepdim=keepdim, directions=directions, dx=dx, dy=dy)


def get_rays_simple(directions, c2w):
    """Loader-style world rays without radii
    (reference dataLoader/ray_utils.py:74-95). c2w is [3|4, 4]."""
    rays_d = directions @ c2w[:3, :3].T
    rays_o = torch.broadcast_to(c2w[:3, 3], rays_d.shape)
    return rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)


def get_rays_from_parameters(H: int, W: int, K, c2w, keepdim: bool = False,
                             use_pixel_centers: bool = True):
    """(reference ray_utils.py:148-159)"""
    directions, dx, dy = get_ray_directions_Ks(
        H, W, K, use_pixel_centers=use_pixel_centers)
    return get_rays(directions, c2w, keepdim=keepdim, dx=dx, dy=dy)


def ndc_rays_blender(H: int, W: int, focal: float, near: float, rays_o,
                     rays_d):
    """Blender-convention NDC warp (reference dataLoader/ray_utils.py:98-123)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (W / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (H / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]
    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


def sample_pdf(gen, bins, weights, n_samples: int, det: bool = False,
               u=None):
    """Hierarchical inverse-CDF sampling (reference
    dataLoader/ray_utils.py:155-197). The uniform draws come from the
    ``torch.Generator`` ``gen`` (the JAX package's key), or are ``u``
    [..., n_samples] when given."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)

    shape = cdf.shape[:-1] + (n_samples,)
    if det:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=cdf.dtype,
                           device=cdf.device).expand(shape)
    elif u is None:
        u = torch.rand(shape, generator=gen, dtype=cdf.dtype,
                       device=cdf.device)
    u = u.contiguous()

    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)

    cdf_g0 = torch.gather(cdf, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    bins_g0 = torch.gather(bins, -1, torch.clamp(below, max=bins.shape[-1] - 1))
    bins_g1 = torch.gather(bins, -1, torch.clamp(above, max=bins.shape[-1] - 1))

    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < 1e-5, 1.0, denom)
    t = (u - cdf_g0) / denom
    return bins_g0 + t * (bins_g1 - bins_g0)


def depth2dist(z_vals, cos_angle):
    """(reference dataLoader/ray_utils.py:10-18)"""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    return dists * cos_angle[..., None]


def ndc2dist(ndc_pts, cos_angle):
    """(reference dataLoader/ray_utils.py:21-26)"""
    dists = torch.linalg.norm(ndc_pts[:, 1:] - ndc_pts[:, :-1], dim=-1)
    return torch.cat([dists, 1e10 * cos_angle[..., None]], dim=-1)


def dda(rays_o, rays_d, bbox_3d):
    """AABB entry/exit per ray (reference dataLoader/ray_utils.py:200-207)."""
    inv_d = 1.0 / (rays_d + 1e-6)
    t_min = (bbox_3d[:1] - rays_o) * inv_d
    t_max = (bbox_3d[1:] - rays_o) * inv_d
    t = torch.stack([t_min, t_max])
    near = torch.amax(torch.amin(t, dim=0), dim=-1, keepdim=True)
    far = torch.amin(torch.amax(t, dim=0), dim=-1, keepdim=True)
    return near, far


def ray_marcher(rays, n_samples: int = 64, lindisp: bool = False,
                perturb: float = 0.0, bbox_3d=None, gen=None, noise=None):
    """Near/far-carrying ray sampler (reference
    dataLoader/ray_utils.py:210-253). rays [N, 8] = (ori, dir, near, far).
    With ``perturb`` the uniform noise [N, n_samples] is ``noise`` when
    given, else drawn from ``gen``."""
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    if bbox_3d is not None:
        near, far = dda(rays_o, rays_d, bbox_3d)
    z_steps = torch.linspace(0.0, 1.0, n_samples, dtype=rays.dtype,
                             device=rays.device)
    if not lindisp:
        z_vals = near * (1 - z_steps) + far * z_steps
    else:
        z_vals = 1.0 / (1.0 / near * (1 - z_steps) + 1.0 / far * z_steps)
    z_vals = torch.broadcast_to(z_vals, (rays.shape[0], n_samples))
    if perturb > 0:
        if noise is None:
            noise = torch.rand(z_vals.shape, generator=gen, dtype=rays.dtype,
                               device=rays.device)
        mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        upper = torch.cat([mid, z_vals[:, -1:]], -1)
        lower = torch.cat([z_vals[:, :1], mid], -1)
        z_vals = lower + (upper - lower) * perturb * noise
    xyz = rays_o[:, None] + rays_d[:, None] * z_vals[..., None]
    return xyz, rays_o, rays_d, z_vals


def read_pfm(filename: str):
    """PFM depth reader (reference dataLoader/ray_utils.py:256-291); host
    numpy -> (image [H, W] or [H, W, 3], scale)."""
    import re

    with open(filename, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")
        dims = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode("utf-8"))
        if not dims:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)), scale
