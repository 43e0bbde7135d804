"""Inputs and weights of a run, made from its seed on its device.

Everything a cell feeds the program (weights, frames, masks, candidate
rays, ray pools, the alpha mask) is drawn here, on the device, in a few
large calls of a ``torch.Generator`` on that device. The program and the
plain reference get the same tensors. Each kind of input has its own
stream of the seed, so that one more draw of one kind moves no other.

Parameter dicts are laid out as ``iffnerf_tpu_torch`` takes them (Linear
weights ``[in, out]``, planes ``[H, W, R]``, lines ``[L, R]``); the
reference reads the same layout.
"""

from __future__ import annotations

import math

import torch

STREAMS = {"weights": 1, "frames": 2, "rays": 3, "pool": 4, "draws": 5}


def generator(seed: int, dev, stream: str) -> torch.Generator:
    """A generator on ``dev`` for one kind of input of the run ``seed``
    (any whole number up to 2**63)."""
    g = torch.Generator(device=dev)
    g.manual_seed((int(seed) * 1_000_003 + STREAMS[stream]) % (1 << 63))
    return g


def _carve(flat: torch.Tensor, shapes):
    out, at = [], 0
    for shape in shapes:
        n = math.prod(shape)
        out.append(flat[at:at + n].view(shape))
        at += n
    return out


def _uniform(g, n, dev):
    return torch.rand(n, generator=g, device=dev).mul_(2.0).sub_(1.0)


def linears(g, dev, dims: dict, bias=True, scale=None):
    """Linear layers ``{name: (in, out)}`` drawn U(-b, b) in one call, b =
    1/sqrt(in) (torch's default) or ``scale(in, out)``."""
    shapes = []
    for i, o in dims.values():
        shapes += [(i, o)] + ([(o,)] if bias else [])
    flat = _uniform(g, sum(math.prod(s) for s in shapes), dev)
    parts = iter(_carve(flat, shapes))
    out = {}
    for name, (i, o) in dims.items():
        b = scale(i, o) if scale else 1.0 / math.sqrt(i)
        layer = {"w": next(parts).mul_(b)}
        if bias:
            layer["b"] = next(parts).mul_(b)
        out[name] = layer
    return out


def vit_params(g, dev, vit: dict, layerscale: float):
    """A DINOv2-style ViT's parameters: truncated normals (std 0.02, cut at
    two deviations) for the patch embedding, position embedding and block
    weights, the cls token at std 1e-6, zero biases, unit norms and
    LayerScale ``layerscale``."""
    d, p, depth = vit["dim"], vit["patch_size"], vit["depth"]
    h = d * vit["mlp_ratio"]
    n_tok = 1 + (vit["img_size"] // p) ** 2
    shapes = [(p, p, 3, d), (1, d), (n_tok, d)]
    for _ in range(depth):
        shapes += [(d, 3 * d), (d, d), (d, h), (h, d)]
    flat = torch.randn(sum(math.prod(s) for s in shapes), generator=g,
                       device=dev).clamp_(-2.0, 2.0).mul_(0.02)
    parts = iter(_carve(flat, shapes))
    zeros = lambda n: torch.zeros(n, device=dev)  # noqa: E731
    norm = lambda: {"scale": torch.ones(d, device=dev), "bias": zeros(d)}  # noqa: E731
    params = {"patch_embed": {"w": next(parts), "b": zeros(d)},
              "cls_token": next(parts).mul_(5e-5),
              "pos_embed": next(parts), "norm": norm()}
    blocks = []
    for _ in range(depth):
        qkv, proj, fc1, fc2 = (next(parts) for _ in range(4))
        blocks.append({
            "norm1": norm(), "qkv": {"w": qkv, "b": zeros(3 * d)},
            "proj": {"w": proj, "b": zeros(d)},
            "ls1": torch.full((d,), layerscale, device=dev),
            "norm2": norm(), "fc1": {"w": fc1, "b": zeros(h)},
            "fc2": {"w": fc2, "b": zeros(d)},
            "ls2": torch.full((d,), layerscale, device=dev)})
    params["blocks"] = tuple(blocks)
    return params


def ray_in_dim(pose: dict) -> int:
    return sum(3 + 6 * pose[k] for k in ("ray_pos_pe", "ray_view_pe",
                                        "ray_rgb_pe"))


def id_params(seed: int, dev, pose: dict):
    """The ID module's parameters: the ViT, the ray MLPs (141 -> 256 -> 256,
    then [256 + 141] -> 256 -> 384) and the q and k projections
    (xavier-uniform, zero bias), as IFFNeRF initialises them."""
    g = generator(seed, dev, "weights")
    vit = pose["vit"]
    d, fc, ind = vit["dim"], pose["ray_feature_c"], ray_in_dim(pose)
    pe = 2 + 4 * pose["pe_freqs"]
    mlp = linears(g, dev, {"a": (ind, fc), "b": (fc, fc), "c": (fc + ind, fc),
                           "d": (fc, d)})
    qk = linears(g, dev, {"q": (d + pe, d), "k": (d, d)},
                 scale=lambda i, o: math.sqrt(6.0 / (i + o)))
    for layer in qk.values():
        layer["b"].zero_()
    return {"backbone": vit_params(g, dev, vit, pose["layerscale"]),
            "ray_mlp": (mlp["a"], mlp["b"]), "ray_mlp2": (mlp["c"], mlp["d"]),
            "q_proj": qk["q"], "k_proj": qk["k"]}


def blob_masks(g, dev, n: int, h: int, w: int) -> torch.Tensor:
    """``n`` elliptic object masks [n, h, w] bool, centres within the middle
    half of the frame, semi-axes a fifth to a third of its sides."""
    u = torch.rand((n, 4), generator=g, device=dev)
    cy, cx = (0.25 + 0.5 * u[:, 0]) * h, (0.25 + 0.5 * u[:, 1]) * w
    ry, rx = (0.2 + 0.13 * u[:, 2]) * h, (0.2 + 0.13 * u[:, 3]) * w
    yy = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :]
    return (((yy - cy[:, None, None]) / ry[:, None, None]) ** 2
            + ((xx - cx[:, None, None]) / rx[:, None, None]) ** 2) < 1.0


def frames(seed: int, dev, n: int, h: int, w: int):
    """``n`` distinct frames [n, h, w, 3] in [0, 1) and their masks."""
    g = generator(seed, dev, "frames")
    imgs = torch.rand((n, h, w, 3), generator=g, device=dev)
    return imgs, blob_masks(g, dev, n, h, w)


def candidate_rays(seed: int, dev, points: int, dirs: int):
    """A candidate set shaped as ``explore_field`` makes it: ``points``
    surface points inside the unit ball, each the origin of ``dirs`` rays
    into its outward hemisphere, a colour a ray -> (ori, dirs, rgb), each
    [points * dirs, 3], a point's rays consecutive."""
    g = generator(seed, dev, "rays")
    p = torch.randn((points, 3), generator=g, device=dev)
    p = p / p.norm(dim=-1, keepdim=True)
    p = p * (0.3 + 0.7 * torch.rand((points, 1), generator=g, device=dev))
    d = torch.randn((points, dirs, 3), generator=g, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    d = torch.where((d * p[:, None]).sum(-1, keepdim=True) < 0, -d, d)
    rgb = torch.rand((points * dirs, 3), generator=g, device=dev)
    ori = p[:, None].expand(points, dirs, 3).reshape(-1, 3).contiguous()
    return ori, d.reshape(-1, 3), rgb


def look_at(campos: torch.Tensor) -> torch.Tensor:
    """OpenCV-convention c2w [n, 4, 4] of cameras at ``campos`` [n, 3]
    looking at the origin, z up."""
    z = campos / campos.norm(dim=-1, keepdim=True)
    up = torch.tensor([0.0, 0.0, 1.0], device=campos.device).expand_as(z)
    x = torch.linalg.cross(up, z, dim=-1)
    x = x / x.norm(dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x, dim=-1)
    c2w = torch.eye(4, device=campos.device).repeat(campos.shape[0], 1, 1)
    c2w[:, :3, 0], c2w[:, :3, 1], c2w[:, :3, 2] = x, -y, -z
    c2w[:, :3, 3] = campos
    return c2w


def sphere_cameras(g, dev, n: int, radius: float) -> torch.Tensor:
    """``n`` camera centres [n, 3] on a sphere of ``radius``, evenly round
    the object with jittered azimuth and 10 to 60 degrees of elevation."""
    u = torch.rand((n, 2), generator=g, device=dev)
    theta = 2 * math.pi * (torch.arange(n, device=dev) + u[:, 0]) / n
    phi = torch.deg2rad(10 + 50 * u[:, 1])
    return radius * torch.stack([torch.cos(theta) * torch.cos(phi),
                                 torch.sin(theta) * torch.cos(phi),
                                 torch.sin(phi)], dim=-1)


def id_pool(seed: int, dev, n: int, h: int, w: int, radius: float):
    """The ID module's training pool: ``n`` RGBA frames [n, h, w, 4] (random
    colour, a blob mask as alpha) and their c2w [n, 4, 4] on a sphere."""
    g = generator(seed, dev, "pool")
    rgba = torch.empty((n, h, w, 4), device=dev)
    rgba[..., :3] = torch.rand((n, h, w, 3), generator=g, device=dev)
    rgba[..., 3] = blob_masks(g, dev, n, h, w).float()
    return rgba, look_at(sphere_cameras(g, dev, n, radius))


def ray_pool(seed: int, dev, n: int, h: int, w: int, camera_angle_x: float,
             radius: float):
    """A field-training pool as Blender's loader flattens it: ``n`` frames
    of ``h`` x ``w`` pixel rays [n*h*w, 6] (origin, unit direction) from
    cameras on a sphere looking at the origin, and RGBA targets [n*h*w, 4]
    (a smooth pattern that changes with the view, a blob mask as alpha)."""
    g = generator(seed, dev, "pool")
    focal = 0.5 * w / math.tan(0.5 * camera_angle_x)
    jj, ii = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32),
                            indexing="ij")
    cam = torch.stack([(ii + 0.5 - w / 2) / focal, -(jj + 0.5 - h / 2) / focal,
                       -torch.ones_like(ii)], dim=-1).reshape(-1, 3)
    centres = sphere_cameras(g, dev, n, radius)
    c2w = look_at(centres)
    # OpenCV c2w to the OpenGL camera frame of Blender's rays
    rot = c2w[:, :3, :3] * torch.tensor([1.0, -1.0, -1.0], device=dev)
    dirs = torch.einsum("nij,pj->npi", rot, cam)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    rays = torch.cat([centres[:, None].expand(n, h * w, 3), dirs], dim=-1)
    rgbs = torch.empty((n, h * w, 4), device=dev)
    yy, xx = jj.reshape(-1, 1) / h, ii.reshape(-1, 1) / w
    theta = torch.atan2(centres[:, 1], centres[:, 0])[:, None, None]
    rgbs[..., :3] = 0.5 + 0.4 * torch.sin(
        6.0 * yy * torch.tensor([1.0, 2.0, 3.0], device=dev) + 4.0 * xx
        + theta)
    rgbs[..., 3] = blob_masks(g, dev, n, h, w).reshape(n, h * w).float()
    return rays.reshape(-1, 6), rgbs.reshape(-1, 4)


def cluster_volume(dev, grid, spread: float = 2.5) -> torch.Tensor:
    """An occupancy volume [gz, gy, gx] float32 (1 occupied) over the AABB
    +-1.5: a central ball and six satellites on the axes, ``spread``
    times apart (2.5: about 8 % occupied, lego's share)."""
    gx, gy, gz = grid
    axes = [torch.linspace(-1.5, 1.5, n, device=dev) for n in (gz, gy, gx)]
    z, y, x = torch.meshgrid(*axes, indexing="ij")
    balls = [((0.0, 0.0, 0.0), 0.22)] + [
        (tuple(0.47 * s * (j == a) for j in range(3)), 0.125)
        for a in range(3) for s in (1, -1)]
    vol = torch.zeros((gz, gy, gx), dtype=torch.bool, device=dev)
    for (cx, cy, cz), rad in balls:
        vol |= ((x - spread * cx) ** 2 + (y - spread * cy) ** 2
                + (z - spread * cz) ** 2) < (2.85 * rad) ** 2
    return vol.float()


MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)


def field_params(seed: int, dev, field: dict, density=(0.5, 0.1),
                 app=(0.0, 0.1)):
    """A TensorVMSplit or TensorCP field drawn from the seed: factor grids
    normal (``density`` and ``app`` give mean and deviation; a density mean
    of 0.5 makes sigma about 2 everywhere, an opaque field, which the alpha
    mask cuts to the object), ``basis_mat`` and the Ref shading head
    U(+-1/sqrt(in))."""
    g = generator(seed, dev, "weights")
    gs = field["grid_size"]
    cp = field["model_name"] == "TensorCP"
    groups = []
    for kind, comps in (("density", field["density_n_comp"]),
                        ("app", field["app_n_comp"])):
        if cp:
            groups.append((f"{kind}_line", [(gs[VEC_MODE[i]], comps[0])
                                            for i in range(3)], kind))
        else:
            groups.append((f"{kind}_plane", [(gs[MAT_MODE[i][1]],
                                              gs[MAT_MODE[i][0]], comps[i])
                                             for i in range(3)], kind))
            groups.append((f"{kind}_line", [(gs[VEC_MODE[i]], comps[i])
                                            for i in range(3)], kind))
    shapes = [s for _, ss, _ in groups for s in ss]
    flat = torch.randn(sum(math.prod(s) for s in shapes), generator=g,
                       device=dev)
    parts = iter(_carve(flat, shapes))
    params = {}
    for name, ss, kind in groups:
        mean, std = density if kind == "density" else app
        params[name] = tuple(next(parts).mul_(std).add_(mean) for _ in ss)
    a, fc = field["app_dim"], field["feature_c"]
    r_app = field["app_n_comp"][0] if cp else sum(field["app_n_comp"])
    params["basis_mat"] = linears(g, dev, {"m": (r_app, a)}, bias=False)["m"]
    ide = sum(2 ** i + 1 for i in range(4)) * 2
    params["shading"] = linears(g, dev, {
        "diffuse": (a, 3), "tint": (a, 3), "roughness": (a, 1),
        "bottleneck": (a, fc), "specular": (fc + ide + 1, 3),
        "normal": (a, 3)})
    return params
