"""TensoRF's training step, plain (TensoRF ``tensorBase.py``,
``tensoRF.py``, ``train.py``; the Ref head of Ref-NeRF as IFFNeRF's
``models/ref.py`` has it).

Samples: equidistant along each ray from its entry into the AABB (clamped
to [near, far]), ``step`` apart, shifted by one jitter draw a ray; a sample
counts where it lies in the AABB and the alpha mask (trilinear, zero
outside) is above 0. Features (``align_corners=True`` bilinear and linear
interpolation, zero outside the grid): VM, plane i at (xyz[m0], xyz[m1])
times line i at xyz[v] for the pairs (0, 1), (0, 2), (1, 2) and v = 2, 1,
0, density summed over the ranks and pairs, appearance concatenated and
through ``basis_mat``; CP, the three lines' product rank by rank. sigma =
softplus(feature - 10) where a sample counts; alpha, transmittance (with
1e-10) and weights over ``dist * 25``; appearance only where a weight
passes the threshold, accumulated along the ray and shaded once a ray by
the Ref head; composited over the background. The loss: the mean square
against the RGBA targets blended over the background, L1 of the density
factors, 0.1 x mean(exp|alpha|).

The Ref head's directional encoding (Ref-NeRF's IDE, degree 4) is taken
in float64 from the spherical harmonics' monomial expansion, then cast
back.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)
RGB_PADDING = 0.001


def _axis(c: torch.Tensor, size: int):
    p = (c + 1.0) * 0.5 * (size - 1)
    i0 = torch.floor(p)
    w = p - i0
    i0 = i0.long()
    out = []
    for i in (i0, i0 + 1):
        ok = (i >= 0) & (i <= size - 1)
        out.append((i.clamp(0, size - 1), ok))
    return out, w


def lerp_line(line: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``line`` [L, R] at normalised coords ``c`` [N] -> [N, R]."""
    ((i0, v0), (i1, v1)), w = _axis(c, line.shape[0])
    w = w[:, None]
    return line[i0] * (v0[:, None] * (1 - w)) + line[i1] * (v1[:, None] * w)


def lerp_plane(plane: torch.Tensor, x: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """``plane`` [H, W, R] at x (along W) and y (along H) -> [N, R]."""
    h, w, _ = plane.shape
    xs, wx = _axis(x, w)
    ys, wy = _axis(y, h)
    out = 0.0
    for (yi, vy), fy in zip(ys, (1 - wy, wy)):
        for (xi, vx), fx in zip(xs, (1 - wx, wx)):
            out = out + plane[yi, xi] * ((vy & vx) * fy * fx)[:, None]
    return out


def mask_lookup(volume: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Trilinear value of ``volume`` [D, H, W] at coords ``c`` [N, 3]
    (x along W, z along D), zero outside."""
    d, h, w = volume.shape
    xs, wx = _axis(c[:, 0], w)
    ys, wy = _axis(c[:, 1], h)
    zs, wz = _axis(c[:, 2], d)
    out = 0.0
    for (zi, vz), fz in zip(zs, (1 - wz, wz)):
        for (yi, vy), fy in zip(ys, (1 - wy, wy)):
            for (xi, vx), fx in zip(xs, (1 - wx, wx)):
                out = out + volume[zi, yi, xi] * (vz & vy & vx) * fz * fy * fx
    return out


def features(field: dict, params, c: torch.Tensor):
    """(sigma feature [N], appearance feature [N, app_dim]) at normalised
    coords ``c`` [N, 3]."""
    if field["model_name"] == "TensorCP":
        dens = app = None
        for i in range(3):
            a = lerp_line(params["density_line"][i], c[:, VEC_MODE[i]])
            b = lerp_line(params["app_line"][i], c[:, VEC_MODE[i]])
            dens = a if dens is None else dens * a
            app = b if app is None else app * b
        sigma = dens.sum(-1)
    else:
        sigma, prods = 0.0, []
        for i, (m0, m1) in enumerate(MAT_MODE):
            v = c[:, VEC_MODE[i]]
            sigma = sigma + (lerp_plane(params["density_plane"][i], c[:, m0],
                                        c[:, m1])
                             * lerp_line(params["density_line"][i], v)).sum(-1)
            prods.append(lerp_plane(params["app_plane"][i], c[:, m0], c[:, m1])
                         * lerp_line(params["app_line"][i], v))
        app = torch.cat(prods, -1)
    return sigma, app @ params["basis_mat"]["w"]


def _ide_terms(deg: int = 4):
    """(m, l) of each harmonic, and its monomial coefficients of z."""
    terms = []
    for i in range(deg):
        l_ = 2 ** i
        for m in range(l_ + 1):
            norm = math.sqrt((2 * l_ + 1) * math.factorial(l_ - m)
                             / (4 * math.pi * math.factorial(l_ + m)))
            coeffs = []
            for k in range(l_ - m + 1):
                a = 0.5 * (l_ + k + m - 1.0)
                binom = math.prod(a - j for j in range(l_)) / math.factorial(l_)
                coeffs.append(norm * (-1) ** m * 2 ** l_ * math.factorial(l_)
                              / math.factorial(k) / math.factorial(l_ - k - m)
                              * binom)
            terms.append((m, l_, coeffs))
    return terms


def ide(d: torch.Tensor, kappa_inv: torch.Tensor) -> torch.Tensor:
    """Integrated directional encoding [N, 2M] of unit ``d`` [N, 3], real
    and imaginary parts of each harmonic side by side."""
    d64, k64 = d.double(), kappa_inv.double()
    x, y, z = d64.unbind(-1)
    xy = torch.complex(x, y)
    out = []
    for m, l_, coeffs in _ide_terms():
        zpoly = sum(c * z ** k for k, c in enumerate(coeffs))
        h = xy ** m * zpoly * torch.exp(-0.5 * l_ * (l_ + 1) * k64[:, 0])
        out += [h.real, h.imag]
    return torch.stack(out, -1).to(d.dtype)


def _lin(p, x):
    return x @ p["w"] + p["b"]


def _srgb(x: torch.Tensor) -> torch.Tensor:
    eps = torch.finfo(x.dtype).eps
    return torch.where(x <= 0.0031308, 323.0 / 25.0 * x,
                       (211.0 * torch.clamp_min(x, eps) ** (5.0 / 12.0)
                        - 11.0) / 200.0)


def shade_ref(p, feat: torch.Tensor, viewdirs: torch.Tensor) -> torch.Tensor:
    """The Ref head: rgb [N, 3] of accumulated features [N, app_dim]."""
    raw = _lin(p["normal"], feat)
    n = -raw / torch.clamp_min(raw.norm(dim=-1, keepdim=True), 1e-12)
    tint = torch.sigmoid(_lin(p["tint"], feat))
    rough = F.softplus(_lin(p["roughness"], feat) - 1.0)
    v = -viewdirs
    refl = 2.0 * (n * v).sum(-1, keepdim=True) * n - v
    x = torch.cat([_lin(p["bottleneck"], feat), ide(refl, rough),
                   (n * viewdirs).sum(-1, keepdim=True)], -1)
    spec = torch.sigmoid(_lin(p["specular"], x))
    diff = torch.sigmoid(_lin(p["diffuse"], feat) - math.log(3.0))
    rgb = torch.clamp(_srgb(tint * spec + diff), 0.0, 1.0)
    return rgb * (1.0 + 2.0 * RGB_PADDING) - RGB_PADDING


def step_size(field: dict) -> float:
    """The sample spacing: the mean grid unit (float32) times the step
    ratio."""
    lo, hi = (np.asarray(a, np.float32) for a in field["aabb"])
    units = (hi - lo) / (np.asarray(field["grid_size"], np.float32) - 1)
    return float(np.mean(units) * field["step_ratio"])


def render(field: dict, params, volume, rays, jitter, n_samples: int, bg):
    """(rgb [N, 3], alpha [N, S]) of rays [N, 6] in training."""
    dev = rays.device
    lo, hi = (torch.tensor(a, device=dev) for a in field["aabb"])
    o, d = rays[:, :3], rays[:, 3:6]
    vec = torch.where(d == 0, torch.full_like(d, 1e-6), d)
    t_min = torch.minimum((hi - o) / vec, (lo - o) / vec).amax(-1)
    t_min = t_min.clamp(*field["near_far"])
    z = t_min[:, None] + step_size(field) * (
        torch.arange(n_samples, device=dev)[None] + jitter)
    xyz = o[:, None] + d[:, None] * z[..., None]
    inside = ~((lo > xyz) | (xyz > hi)).any(-1)
    c = ((xyz - lo) * (2.0 / (hi - lo)) - 1.0).reshape(-1, 3)
    inside = inside & (mask_lookup(volume, c.detach()).reshape(inside.shape)
                       > 0)
    feat, app = features(field, params, c)
    sigma = torch.where(inside, F.softplus(
        feat.reshape(inside.shape) + field["density_shift"]), 0.0)
    dist = torch.cat([z[:, 1:] - z[:, :-1], torch.zeros_like(z[:, :1])], -1)
    alpha = 1.0 - torch.exp(-sigma * dist * field["distance_scale"])
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     1.0 - alpha + 1e-10], -1), -1)[:, :-1]
    w = alpha * trans
    use = w > field["ray_march_weight_thres"]
    app = torch.where(use[..., None], app.reshape(w.shape + (-1,)), 0.0)
    acc = w.sum(-1, keepdim=True)
    rgb = shade_ref(params["shading"], (w[..., None] * app).sum(1), d)
    rgb = torch.where(use.any(-1, keepdim=True), rgb, 0.0)
    return torch.clamp(rgb * acc + bg * (1.0 - acc), 0.0, 1.0), alpha


def density_l1(field: dict, params) -> torch.Tensor:
    keys = (("density_line",) if field["model_name"] == "TensorCP"
            else ("density_plane", "density_line"))
    return sum(t.abs().mean() for k in keys for t in params[k])


def loss_and_grads(field: dict, params, volume, rays, rgbs, jitter,
                   n_samples: int, l1: float, white_bg: bool,
                   chunk: int, keep: int | None = None):
    """The step's mse and the gradients of its loss, in blocks of ``chunk``
    rays (the mse and the alpha term are means over the whole batch, so
    each block adds its share). ``keep`` rays of the batch alone, the mean
    over them, where given. ``params``' leaves require grad and gather the
    gradients in ``.grad``."""
    n = rays.shape[0] if keep is None else keep
    bg = torch.full((3,), 1.0 if white_bg else 0.0, device=rays.device)
    mse = torch.zeros((), device=rays.device)
    (l1 * density_l1(field, params)).backward()
    for i in range(0, n, chunk):
        j = min(i + chunk, n)
        rgb, alpha = render(field, params, volume, rays[i:j], jitter[i:j],
                            n_samples, bg)
        tgt = rgbs[i:j]
        tgt = torch.clamp(tgt[:, :3] * tgt[:, 3:] + bg * (1 - tgt[:, 3:]),
                          0.0, 1.0)
        part = torch.square(rgb - tgt).sum() / (n * 3)
        (part + 0.1 * torch.exp(alpha.abs()).sum() / (n * n_samples)
         ).backward()
        mse = mse + part.detach()
    return mse
