"""Grid interpolation with the semantics of ``F.grid_sample(...,
mode='bilinear', align_corners=True, padding_mode='zeros')``, in the JAX
package's layout (reference: models/tensoRF.py:229-253,
models/tensorBase.py:66-72):

  * normalized coords in [-1, 1]; pixel coord = (g + 1) / 2 * (size - 1)
  * out-of-range corner texels contribute zero (``zeros`` padding)

Feature channels live on the last axis: planes are ``[H, W, C]``, lines
``[L, C]``, volumes ``[D, H, W]`` (scalar). Each sampler stacks its corner
indices (2, 4 or 8 a point; int32, clamped as the JAX package clamps them)
and fetches all of them with one ``gather_rows`` of the flat ``[L, C]``,
``[H*W, C]`` or ``[D*H*W, 1]`` view; validity masks and lerps are plain
torch, in the JAX package's order.
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


def _axis(g, size: int):
    """Both corners of normalized coords ``g`` on an axis of ``size``
    texels -> (clamped lower, clamped upper, lower valid, upper valid,
    weight of the upper corner)."""
    p = _to_pixel(g, size)
    i0 = torch.floor(p).to(torch.int32)
    w = p - i0
    i0c, v0 = _corner(i0, size)
    i1c, v1 = _corner(i0 + 1, size)
    return i0c, i1c, v0, v1, w


def corners_1d(size: int, coords: torch.Tensor):
    """Linear corners of a line of ``size`` texels at ``coords`` [...] ->
    (row indices [2, ...] int32, validity [2, ...], weight [...])."""
    i0, i1, v0, v1, w = _axis(coords, size)
    return torch.stack([i0, i1]), torch.stack([v0, v1]), w


def corners_2d(h: int, w: int, coords: torch.Tensor):
    """Bilinear corners of a plane [h, w] at ``coords`` [..., 2] (x indexes
    w, y indexes h) -> (row indices of the flat plane [4, ...] int32 in the
    order 00, 01, 10, 11 (y, x), validity [4, ...], (wx, wy))."""
    x0, x1, vx0, vx1, wx = _axis(coords[..., 0], w)
    y0, y1, vy0, vy1, wy = _axis(coords[..., 1], h)
    idx = torch.stack([y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1])
    valid = torch.stack([vy0 & vx0, vy0 & vx1, vy1 & vx0, vy1 & vx1])
    return idx, valid, (wx, wy)


def corners_3d(d: int, h: int, w: int, coords: torch.Tensor):
    """Trilinear corners of a volume [d, h, w] at ``coords`` [..., 3] (x, y,
    z index w, h, d) -> (row indices of the flat volume [8, ...] int32 in
    the order 000 ... 111 (z, y, x), validity [8, ...], (wx, wy, wz))."""
    x0, x1, vx0, vx1, wx = _axis(coords[..., 0], w)
    y0, y1, vy0, vy1, wy = _axis(coords[..., 1], h)
    z0, z1, vz0, vz1, wz = _axis(coords[..., 2], d)
    idx, valid = [], []
    for zi, vz in ((z0, vz0), (z1, vz1)):
        for yi, vy in ((y0, vy0), (y1, vy1)):
            for xi, vx in ((x0, vx0), (x1, vx1)):
                idx.append((zi * h + yi) * w + xi)
                valid.append(vz & vy & vx)
    return torch.stack(idx), torch.stack(valid), (wx, wy, wz)


def _fetch(table: torch.Tensor, idx: torch.Tensor, gather=None) -> torch.Tensor:
    """Rows of ``table`` [R, C] at int32 ``idx`` [...] -> [..., C], through
    ``gather`` (None: ``gather_rows``)."""
    rows = (gather or gather_rows)(table, idx.reshape(-1))
    return rows.reshape(idx.shape + (table.shape[1],))


def grid_sample_1d(line: torch.Tensor, coords: torch.Tensor,
                   gather=None) -> torch.Tensor:
    """Linear interpolation along ``line`` [L, C] at ``coords`` [...] ->
    [..., C]; ``gather`` fetches the texels (None: ``gather_rows``)."""
    idx, valid, w1 = corners_1d(line.shape[0], coords)
    f0, f1 = _fetch(line, idx, gather) * valid[..., None]
    w1 = w1[..., None]
    return f0 * (1.0 - w1) + f1 * w1


def grid_sample_2d(plane: torch.Tensor, coords: torch.Tensor,
                   gather=None) -> torch.Tensor:
    """Bilinear interpolation on ``plane`` [H, W, C] at ``coords`` [..., 2]
    (x indexes W, y indexes H) -> [..., C]; ``gather`` fetches the texels
    (None: ``gather_rows``)."""
    h, w, c = plane.shape
    idx, valid, (wx, wy) = corners_2d(h, w, coords)
    f00, f01, f10, f11 = (_fetch(plane.reshape(h * w, c), idx, gather)
                          * valid[..., None])
    wx, wy = wx[..., None], wy[..., None]
    top = f00 * (1.0 - wx) + f01 * wx
    bot = f10 * (1.0 - wx) + f11 * wx
    return top * (1.0 - wy) + bot * wy


def grid_sample_3d(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation in ``volume`` [D, H, W] at ``coords``
    [..., 3] (x, y, z index W, H, D) -> [...]."""
    d, h, w = volume.shape
    idx, valid, (wx, wy, wz) = corners_3d(d, h, w, coords)
    c = torch.where(valid, _fetch(volume.reshape(-1, 1), idx)[..., 0], 0.0)
    c000, c001, c010, c011, c100, c101, c110, c111 = c
    c00 = c000 * (1 - wx) + c001 * wx
    c01 = c010 * (1 - wx) + c011 * wx
    c10 = c100 * (1 - wx) + c101 * wx
    c11 = c110 * (1 - wx) + c111 * wx
    c0 = c00 * (1 - wy) + c01 * wy
    c1 = c10 * (1 - wy) + c11 * wy
    return c0 * (1 - wz) + c1 * wz
