"""Grid interpolation with the semantics of ``F.grid_sample(...,
mode='bilinear', align_corners=True, padding_mode='zeros')``, in the JAX
package's layout (reference: models/tensoRF.py:229-253,
models/tensorBase.py:66-72):

  * normalized coords in [-1, 1]; pixel coord = (g + 1) / 2 * (size - 1)
  * out-of-range corner texels contribute zero (``zeros`` padding)

Feature channels live on the last axis: planes are ``[H, W, C]``, lines
``[L, C]``, volumes ``[D, H, W]`` (scalar). Every texel fetch is one
``gather_rows`` of the flat ``[H*W, C]``, ``[L, C]`` or ``[D*H*W, 1]``
view with int32 indices, clamped as the JAX package clamps them; validity
masks and lerps are plain torch, in the JAX package's order.
"""

from __future__ import annotations

import torch

from iffnerf_tpu_torch.ops.gather import gather_rows


def _to_pixel(g, size: int):
    """Normalized [-1,1] -> continuous pixel coord, align_corners=True."""
    return (g + 1.0) * 0.5 * (size - 1)


def _corner(idx, size: int):
    """Clamped gather index + in-range validity flag for zeros padding."""
    valid = (idx >= 0) & (idx <= size - 1)
    return idx.clamp(0, size - 1), valid


def _fetch(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` [R, C] at int32 ``idx`` [...] -> [..., C]."""
    rows = gather_rows(table, idx.reshape(-1))
    return rows.reshape(idx.shape + (table.shape[1],))


def grid_sample_1d(line: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Linear interpolation along ``line`` [L, C] at ``coords`` [...] ->
    [..., C]."""
    size = line.shape[0]
    p = _to_pixel(coords, size)
    i0 = torch.floor(p).to(torch.int32)
    w1 = (p - i0)[..., None]
    i0c, v0 = _corner(i0, size)
    i1c, v1 = _corner(i0 + 1, size)
    f0 = _fetch(line, i0c) * v0[..., None]
    f1 = _fetch(line, i1c) * v1[..., None]
    return f0 * (1.0 - w1) + f1 * w1


def grid_sample_2d(plane: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation on ``plane`` [H, W, C] at ``coords`` [..., 2]
    (x indexes W, y indexes H) -> [..., C]."""
    h, w, c = plane.shape
    px = _to_pixel(coords[..., 0], w)
    py = _to_pixel(coords[..., 1], h)
    x0 = torch.floor(px).to(torch.int32)
    y0 = torch.floor(py).to(torch.int32)
    wx = (px - x0)[..., None]
    wy = (py - y0)[..., None]

    x0c, vx0 = _corner(x0, w)
    x1c, vx1 = _corner(x0 + 1, w)
    y0c, vy0 = _corner(y0, h)
    y1c, vy1 = _corner(y0 + 1, h)

    flat = plane.reshape(h * w, c)

    def tex(yi, xi, vy, vx):
        return _fetch(flat, yi * w + xi) * (vy & vx)[..., None]

    f00 = tex(y0c, x0c, vy0, vx0)
    f01 = tex(y0c, x1c, vy0, vx1)
    f10 = tex(y1c, x0c, vy1, vx0)
    f11 = tex(y1c, x1c, vy1, vx1)

    top = f00 * (1.0 - wx) + f01 * wx
    bot = f10 * (1.0 - wx) + f11 * wx
    return top * (1.0 - wy) + bot * wy


def grid_sample_3d(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation in ``volume`` [D, H, W] at ``coords``
    [..., 3] (x, y, z index W, H, D) -> [...]."""
    d, h, w = volume.shape
    px = _to_pixel(coords[..., 0], w)
    py = _to_pixel(coords[..., 1], h)
    pz = _to_pixel(coords[..., 2], d)
    x0 = torch.floor(px).to(torch.int32)
    y0 = torch.floor(py).to(torch.int32)
    z0 = torch.floor(pz).to(torch.int32)
    wx, wy, wz = px - x0, py - y0, pz - z0

    x0c, vx0 = _corner(x0, w)
    x1c, vx1 = _corner(x0 + 1, w)
    y0c, vy0 = _corner(y0, h)
    y1c, vy1 = _corner(y0 + 1, h)
    z0c, vz0 = _corner(z0, d)
    z1c, vz1 = _corner(z0 + 1, d)

    flat = volume.reshape(-1, 1)

    def tex(zi, yi, xi, vz, vy, vx):
        f = _fetch(flat, (zi * h + yi) * w + xi)[..., 0]
        return torch.where(vz & vy & vx, f, 0.0)

    c000 = tex(z0c, y0c, x0c, vz0, vy0, vx0)
    c001 = tex(z0c, y0c, x1c, vz0, vy0, vx1)
    c010 = tex(z0c, y1c, x0c, vz0, vy1, vx0)
    c011 = tex(z0c, y1c, x1c, vz0, vy1, vx1)
    c100 = tex(z1c, y0c, x0c, vz1, vy0, vx0)
    c101 = tex(z1c, y0c, x1c, vz1, vy0, vx1)
    c110 = tex(z1c, y1c, x0c, vz1, vy1, vx0)
    c111 = tex(z1c, y1c, x1c, vz1, vy1, vx1)

    c00 = c000 * (1 - wx) + c001 * wx
    c01 = c010 * (1 - wx) + c011 * wx
    c10 = c100 * (1 - wx) + c101 * wx
    c11 = c110 * (1 - wx) + c111 * wx
    c0 = c00 * (1 - wy) + c01 * wy
    c1 = c10 * (1 - wy) + c11 * wy
    return c0 * (1 - wz) + c1 * wz
