"""IFFNeRF's identification module and pose solve, plain.

The image side (IFFNeRF ``identification_module.py``): the frame resized
bicubic (antialiased) so that its short side is 256, centre-cropped to 224,
ImageNet-normalised, through DINOv2 ViT-S/14's ``forward_features`` (the
patch tokens after the final LayerNorm), concatenated with a 2-D position
encoding of the 16 x 16 patch grid (raw xy, then sin and cos of three
octaves) and projected to q. The patch validity is the mask resized
bilinear the same way and again to the patch grid, above 0.1.

The ray side (``ray_preprocessor.py``): [ori, dir, rgb, PE(ori, 8), PE(dir,
8), PE(rgb, 6)] -> ReLU(256) -> ReLU(256) -> concat with the input ->
ReLU(256) -> 384, then k. A ray's score is the softmax over all rays of
q . k / sqrt(384), summed over the valid patches.

The solve (``test.py``, ``pose_geometry.py``): the top k rays by score
(lower index first among equal scores), those whose origin another of
them shares dropped, the weighted least-squares meeting point of the rest,
the rays that point away from it dropped, the viewing direction as the
weighted mean of the remaining directions, a look-at rotation about the
model's up. It runs in float64 on the host.

The ID loss (``loss.py``): 1 - tanh(distance of the true camera centre from
each ray), the ray clamped to its origin behind it, scaled to sum to the
valid patches, against the scores by the mean square.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _resize(x: torch.Tensor, h: int, w: int, mode: str) -> torch.Tensor:
    """[H, W, C] -> [h, w, C], antialiased, half-pixel centres."""
    y = F.interpolate(x.permute(2, 0, 1)[None], size=(h, w), mode=mode,
                      antialias=True, align_corners=False)
    return y[0].permute(1, 2, 0)


def _short_side(h: int, w: int, size: int):
    """torchvision Resize(size): the short side to ``size``, the long one
    truncated."""
    return (size, int(size * w / h)) if h <= w else (int(size * h / w), size)


def _crop(x: torch.Tensor, crop: int) -> torch.Tensor:
    h, w = x.shape[:2]
    top, left = int(round((h - crop) / 2.0)), int(round((w - crop) / 2.0))
    return x[top:top + crop, left:left + crop]


def image_input(pose: dict, img: torch.Tensor) -> torch.Tensor:
    h, w = img.shape[:2]
    x = _crop(_resize(img, *_short_side(h, w, pose["resize_size"]), "bicubic"),
              pose["crop_size"])
    mean = torch.tensor(MEAN, device=img.device)
    std = torch.tensor(STD, device=img.device)
    return (x - mean) / std


def patch_valid(pose: dict, mask: torch.Tensor) -> torch.Tensor:
    m = mask.float()[..., None]
    h, w = m.shape[:2]
    m = _crop(_resize(m, *_short_side(h, w, pose["resize_size"]), "bilinear"),
              pose["crop_size"])
    g = pose["vit"]["img_size"] // pose["vit"]["patch_size"]
    m = _resize(m, g, g, "bilinear")
    return (m[..., 0] > pose["mask_threshold"]).reshape(-1)


def _ln(p, x):
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], 1e-6)


def vit_patch_tokens(params, vit: dict, x: torch.Tensor) -> torch.Tensor:
    """DINOv2 ``forward_features``' normalised patch tokens [P, D] of a
    normalised [224, 224, 3] image: a 14 x 14 patch embedding, the cls
    token and position embedding, pre-norm blocks with LayerScale (exact
    GELU, biased LayerNorm variance, eps 1e-6), the final LayerNorm."""
    p, d, heads = vit["patch_size"], vit["dim"], vit["num_heads"]
    g = vit["img_size"] // p
    patches = x.reshape(g, p, g, p, 3).permute(0, 2, 1, 3, 4).reshape(
        g * g, p * p * 3)
    t = patches @ params["patch_embed"]["w"].reshape(p * p * 3, d) \
        + params["patch_embed"]["b"]
    t = torch.cat([params["cls_token"], t]) + params["pos_embed"]
    n, hd = t.shape[0], d // heads
    for b in params["blocks"]:
        y = _ln(b["norm1"], t)
        qkv = (y @ b["qkv"]["w"] + b["qkv"]["b"]).reshape(n, 3, heads, hd)
        q, k, v = qkv.permute(1, 2, 0, 3)
        att = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(hd), dim=-1)
        y = (att @ v).transpose(0, 1).reshape(n, d)
        t = t + b["ls1"] * (y @ b["proj"]["w"] + b["proj"]["b"])
        y = _ln(b["norm2"], t)
        y = F.gelu(y @ b["fc1"]["w"] + b["fc1"]["b"])
        t = t + b["ls2"] * (y @ b["fc2"]["w"] + b["fc2"]["b"])
    return _ln(params["norm"], t)[1:]


def patch_encoding(pose: dict, dev) -> torch.Tensor:
    g = pose["vit"]["img_size"] // pose["vit"]["patch_size"]
    lin = np.linspace(-1.0, 1.0, g)
    xy = np.stack(np.meshgrid(lin, lin, indexing="ij"), -1).reshape(-1, 2)
    octaves = (xy[..., None] * 2.0 ** np.arange(pose["pe_freqs"])).reshape(
        xy.shape[0], -1)
    return torch.as_tensor(np.concatenate(
        [xy, np.sin(octaves), np.cos(octaves)], -1), dtype=torch.float32,
        device=dev)


def queries(params, pose: dict, img, mask):
    """-> (q [P, D], patch validity [P] bool) of one frame."""
    feats = vit_patch_tokens(params["backbone"], pose["vit"],
                             image_input(pose, img))
    x = torch.cat([feats, patch_encoding(pose, img.device)], -1)
    return x @ params["q_proj"]["w"] + params["q_proj"]["b"], \
        patch_valid(pose, mask)


def _pe(x: torch.Tensor, freqs: int) -> torch.Tensor:
    """[..., K] -> [sin(x_k 2^f) ..., cos(x_k 2^f) ...], channel-major."""
    bands = 2.0 ** torch.arange(freqs, dtype=x.dtype, device=x.device)
    y = (x[..., None] * bands).reshape(x.shape[:-1] + (-1,))
    return torch.cat([torch.sin(y), torch.cos(y)], -1)


def ray_features(params, pose: dict, ori, dirs, rgb) -> torch.Tensor:
    x = torch.cat([ori, dirs, rgb, _pe(ori, pose["ray_pos_pe"]),
                   _pe(dirs, pose["ray_view_pe"]),
                   _pe(rgb, pose["ray_rgb_pe"])], -1)
    h = x
    for layer in params["ray_mlp"]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    h = torch.cat([h, x], -1)
    a, b = params["ray_mlp2"]
    h = torch.relu(h @ a["w"] + a["b"])
    return h @ b["w"] + b["b"]


def keys(params, pose: dict, ori, dirs, rgb, rows: int = 1 << 17):
    """k [R, D] of every ray, in blocks of ``rows``."""
    k = params["k_proj"]
    return torch.cat([ray_features(params, pose, ori[i:i + rows],
                                   dirs[i:i + rows], rgb[i:i + rows])
                      @ k["w"] + k["b"]
                      for i in range(0, ori.shape[0], rows)])


def scores(q, valid, k) -> torch.Tensor:
    """[R] softmax columns over the rays, summed over the valid patches."""
    att = torch.softmax(q @ k.T / math.sqrt(q.shape[-1]), dim=-1)
    return (att * valid[:, None]).sum(0)


def topk(s: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest of ``s``, lower index first among equal
    values, in descending order."""
    v = s.detach().cpu().numpy()
    order = np.lexsort((np.arange(v.shape[0]), -v.astype(np.float64)))
    return torch.as_tensor(order[:k])


def _unit(v):
    return v / np.linalg.norm(v)


def solve(ori: np.ndarray, dirs: np.ndarray, w: np.ndarray,
          up: np.ndarray) -> np.ndarray:
    """c2w [4, 4] float64 from the top rays' origins, directions and
    scores (IFFNeRF test.py:133-194 with its NaN exits as the identity)."""
    ori, dirs, w = (np.asarray(a, np.float64) for a in (ori, dirs, w))
    same = (ori[:, None, :] == ori[None, :, :]).all(-1)
    keep = (same.sum(-1) == 1).astype(np.float64)
    with np.errstate(all="ignore"):
        w = w * keep
        w = w / w.sum()
        proj = np.eye(3)[None] - dirs[:, :, None] * dirs[:, None, :]
        r = (proj * keep[:, None, None]).sum(0)
        q = (proj @ ori[:, :, None] * keep[:, None, None]).sum(0)[:, 0]
        det = np.linalg.det(r)
        centre = (np.linalg.solve(r, q) if det >= 1e-7 and np.isfinite(det)
                  else np.full(3, np.nan))
        w = w * (((centre[None] - ori) * dirs).sum(-1) > 0)
        w = w / w.sum()
        watch = _unit((dirs * w[:, None]).sum(0))
        z = -watch
        x = _unit(np.cross(_unit(up), z))
        y = _unit(np.cross(z, x))
        rot = np.stack([x, y, z])
        if abs(np.linalg.det(rot)) < 1e-7:
            rot = np.eye(3)
        c2w = np.eye(4)
        c2w[:3, :3] = np.linalg.inv(rot)
        c2w[:3, 3] = centre
    return np.eye(4) if np.isnan(c2w).any() else c2w


def score_target(pose_c2w, ori, dirs) -> torch.Tensor:
    """1 - tanh(distance of the camera centre from each ray) [R]."""
    c = pose_c2w[:3, 3]
    v = c[None] - ori
    t = (v * dirs).sum(-1, keepdim=True)
    near = torch.where(t < 0, ori, ori + t * dirs)
    return 1.0 - torch.tanh(torch.linalg.norm(near - c, dim=-1))


def id_loss(params, pose: dict, img, mask, c2w, ori, dirs, k):
    """One frame's ID loss against the keys ``k`` of rays (ori, dirs)."""
    q, valid = queries(params, pose, img, mask)
    s = scores(q, valid, k)
    target = score_target(c2w, ori, dirs)
    target = (target * (valid.sum() / target.sum())).detach()
    return torch.square(s - target).sum() / s.shape[0]
