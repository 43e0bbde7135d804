"""Identification Module: DINOv2 patch features x ray embeddings via
single-head QK attention (reference identification_module.py,
ray_preprocessor.py, multihead_attention.py).

All 256 patches stay in the attention with a validity mask, and a ray's
score is the validity-weighted sum of its softmax column (the softmax runs
over the ray axis). Matmuls on bf16 operands accumulate in float32 and
round once to bf16 (``nn.matmul``), the numerics of the JAX package.

The banked per-image scoring (``score_rays`` with ``bank=``) goes through
the hand-written kernel of ``ops/banked_attention.py`` unless
``IDConfig.fused_bank`` is False; the exact path below is the oracle for
that kernel and the path training uses.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from iffnerf_tpu_torch.device import as_tensor, resolve_device, tree_to
from iffnerf_tpu_torch.nn import linear_apply, mlp_init, uniform
from iffnerf_tpu_torch.ops.encoding import positional_encoding
from iffnerf_tpu_torch.parallel.mesh import mesh_of, pmax, psum
from iffnerf_tpu_torch.pose.vit import ViTConfig, init_vit, vit_forward_features

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class IDConfig:
    backbone: ViTConfig = ViTConfig()
    resize_size: int = 256
    crop_size: int = 224
    pe_freqs: int = 3          # image-patch PE
    ray_view_pe: int = 8
    ray_pos_pe: int = 8
    ray_rgb_pe: int = 6
    ray_feature_c: int = 256
    mask_threshold: float = 0.1
    # dtype of the ray-side and query matmul inputs; products accumulate in
    # float32 and softmax/score sums stay float32. Inference uses
    # "bfloat16", training "float32".
    compute_dtype: str = "float32"
    # unbanked route: the fused ray-MLP + k projection + logits kernel
    # (ops/fused_ray_attention.py) in place of the plain torch chain
    fused_scoring: bool = False
    # banked route: the two-pass banked-scoring kernel
    # (ops/banked_attention.py); False keeps the exact torch path
    fused_bank: bool = True

    @property
    def img_num_features(self) -> int:
        return self.backbone.dim

    @property
    def pe_channels(self) -> int:
        return 2 + 2 * 2 * self.pe_freqs  # raw xy + sin/cos per freq

    @property
    def ray_in_dim(self) -> int:
        return (3 + 2 * self.ray_pos_pe * 3) + (3 + 2 * self.ray_view_pe * 3) \
            + (3 + 2 * self.ray_rgb_pe * 3)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def init_id_module(gen: torch.Generator, config: IDConfig = IDConfig(),
                   device=None):
    """Random parameters drawn from ``gen`` (a CPU generator), placed on
    ``device`` (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    d = config.img_num_features
    fc = config.ray_feature_c
    params = {
        "backbone": init_vit(gen, config.backbone),
        # RayPreprocessor: mlp (2 layers) + skip-concat mlp2 (2 layers)
        "ray_mlp": mlp_init(gen, [config.ray_in_dim, fc, fc]),
        "ray_mlp2": mlp_init(gen, [fc + config.ray_in_dim, fc, d]),
        # QK attention, xavier-uniform + zero bias
        "q_proj": _xavier_linear(gen, d + config.pe_channels, d),
        "k_proj": _xavier_linear(gen, d, d),
    }
    return tree_to(params, dev)


def _xavier_linear(gen, in_dim, out_dim):
    bound = math.sqrt(6.0 / (in_dim + out_dim))
    return {"w": uniform(gen, (in_dim, out_dim), bound),
            "b": torch.zeros(out_dim, device=gen.device)}


# ---------------------------------------------------------------------------
# Image preprocessing (identification_module.py:36-61)
# ---------------------------------------------------------------------------


def _resize(img: torch.Tensor, out_h: int, out_w: int,
            mode: str) -> torch.Tensor:
    """[H, W, C] -> [out_h, out_w, C], antialiased like ``jax.image.resize``
    (bicubic Keys a=-0.5 / bilinear, half-pixel centres)."""
    x = img.permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(out_h, out_w), mode=mode, antialias=True,
                      align_corners=False)
    return x[0].permute(1, 2, 0)


def _short_side_resize_shape(h: int, w: int, size: int):
    """torchvision ``Resize(size)`` output shape: short side -> ``size``,
    long side TRUNCATED (``int(size * long / short)``, not rounded)."""
    if h <= w:
        return size, int(size * w / h)
    return int(size * h / w), size


def _center_crop_origin(n: int, crop: int) -> int:
    """torchvision ``CenterCrop`` origin: ``int(round((n - crop) / 2.0))``
    with Python's banker's rounding."""
    return int(round((n - crop) / 2.0))


def preprocess_image(config: IDConfig, img: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] in [0,1] -> [224, 224, 3] bicubic-resized (short side 256),
    center-cropped, ImageNet-normalized."""
    h, w = img.shape[:2]
    nh, nw = _short_side_resize_shape(h, w, config.resize_size)
    img = _resize(img, nh, nw, "bicubic")
    top = _center_crop_origin(nh, config.crop_size)
    left = _center_crop_origin(nw, config.crop_size)
    img = img[top:top + config.crop_size, left:left + config.crop_size]
    mean = torch.tensor(IMAGENET_MEAN, dtype=img.dtype, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=img.dtype, device=img.device)
    return (img - mean) / std


def preprocess_mask(config: IDConfig, mask: torch.Tensor) -> torch.Tensor:
    """[H, W] -> [grid*grid] patch-validity bool (bilinear 256 -> crop 224
    -> bilinear to the patch grid, > 0.1)."""
    m = mask.to(torch.float32)[..., None]
    h, w = m.shape[:2]
    nh, nw = _short_side_resize_shape(h, w, config.resize_size)
    m = _resize(m, nh, nw, "bilinear")
    top = _center_crop_origin(nh, config.crop_size)
    left = _center_crop_origin(nw, config.crop_size)
    m = m[top:top + config.crop_size, left:left + config.crop_size]
    g = config.backbone.grid
    m = _resize(m, g, g, "bilinear")
    return (m[..., 0] > config.mask_threshold).reshape(-1)


def img_position_encoding(config: IDConfig, dtype=torch.float32,
                          device="cpu") -> torch.Tensor:
    """[grid*grid, 14] 2-D positional encoding: raw xy + sin/cos octaves."""
    g = config.backbone.grid
    lin = np.linspace(-1.0, 1.0, g)
    pos = np.stack(np.meshgrid(lin, lin, indexing="ij"), axis=-1).reshape(-1, 2)
    freqs = 2.0 ** np.arange(config.pe_freqs)
    pts = (pos[..., None] * freqs).reshape(pos.shape[0], -1)
    out = np.concatenate([pos, np.sin(pts), np.cos(pts)], axis=-1)
    return torch.as_tensor(out, dtype=dtype, device=device)


def image_features(params, config: IDConfig, img: torch.Tensor,
                   mask: torch.Tensor):
    """-> (features_w_pe [P, D+14], patch_valid [P] bool, features [P, D])."""
    norm_img = preprocess_image(config, img)
    patch_valid = preprocess_mask(config, mask)
    feats = vit_forward_features(params["backbone"], norm_img, config.backbone)
    pe = img_position_encoding(config, feats.dtype, feats.device)
    return torch.cat([feats, pe], dim=-1), patch_valid, feats


# ---------------------------------------------------------------------------
# Ray path + attention
# ---------------------------------------------------------------------------


def _cast_linear(layer, dtype):
    return {k: v.to(dtype) for k, v in layer.items()}


def ray_mlp_inputs(config: IDConfig, rays_ori, rays_dir, rays_rgb):
    """[R, ray_in_dim] concatenated raw+PE inputs of the ray MLP, in the
    compute dtype (ray_preprocessor.py:29-33)."""
    indata = [rays_ori, rays_dir, rays_rgb,
              positional_encoding(rays_ori, config.ray_pos_pe),
              positional_encoding(rays_dir, config.ray_view_pe),
              positional_encoding(rays_rgb, config.ray_rgb_pe)]
    return torch.cat(indata, dim=-1).to(config.dtype)


def ray_features(params, config: IDConfig, rays_ori, rays_dir, rays_rgb):
    """Skip-MLP ray embedding (ray_preprocessor.py:29-39) in
    ``config.compute_dtype``; the skip concat is ``[h, x]``."""
    dt = config.dtype
    x = ray_mlp_inputs(config, rays_ori, rays_dir, rays_rgb)
    h = x
    for layer in params["ray_mlp"]:
        h = torch.relu(linear_apply(_cast_linear(layer, dt), h))
    h = torch.cat([h, x], dim=-1)
    h = torch.relu(linear_apply(_cast_linear(params["ray_mlp2"][0], dt), h))
    return linear_apply(_cast_linear(params["ray_mlp2"][1], dt), h)


def image_queries(params, config: IDConfig, img, mask):
    """Image-side half of the scoring: -> (q [P, D] in the compute dtype,
    patch_valid [P], features_img [P, D])."""
    feats_w_pe, patch_valid, feats = image_features(params, config, img, mask)
    dt = config.dtype
    q = linear_apply(_cast_linear(params["q_proj"], dt), feats_w_pe.to(dt))
    return q, patch_valid, feats


def ray_bank(params, config: IDConfig, rays_ori, rays_dir, rays_rgb,
             device=None):
    """Image-independent ray-side keys K [R, D] (ray features + k
    projection) in the compute dtype, built once per candidate-ray set and
    reused for every image of the object. Runs on ``device`` (CUDA unless
    ``device="cpu"``)."""
    dev = resolve_device(device)
    rays_ori, rays_dir, rays_rgb = (as_tensor(t, dev, torch.float32)
                                    for t in (rays_ori, rays_dir, rays_rgb))
    return _ray_keys(tree_to(params, dev), config, rays_ori, rays_dir,
                     rays_rgb)


def _ray_keys(params, config, rays_ori, rays_dir, rays_rgb):
    feats_rays = ray_features(params, config, rays_ori, rays_dir, rays_rgb)
    dt = config.dtype
    return linear_apply(_cast_linear(params["k_proj"], dt), feats_rays.to(dt))


def score_rays(params, config: IDConfig, q, patch_valid, rays_ori, rays_dir,
               rays_rgb, axis_name: str | None = None, bank=None):
    """Ray-side scoring: K projection, QK^T logits, softmax over the ray
    axis, validity-weighted column sum (identification_module.py:162-168).
    ``bank`` supplies precomputed keys (``ray_bank``) and skips the
    ray-feature chain.

    With ``bank`` and ``config.fused_bank`` the scores come from the
    banked-scoring kernel and attention is None, where the kernel takes
    the shape (``banked_attention.kernel_takes``). Otherwise the exact
    path runs, as the JAX package falls back to XLA where its kernel
    cannot tile: float32 logits divided by sqrt(D) after the matmul.

    With ``axis_name`` the rays are this rank's shard of a mesh axis
    (``parallel.mesh``) and the exact path runs, its softmax over the
    whole ray set (``softmax_over_rays``), so that the shard's scores are
    the full softmax's.

    Returns (scores [R], attention [P, R] | None)."""
    if bank is not None and config.fused_bank and axis_name is None:
        from iffnerf_tpu_torch.ops import banked_attention as banked

        if bank.shape[0] > 0 and banked.kernel_takes(
                bank.dtype, q.shape[0], bank.shape[1]):
            return banked.banked_scores_fused(bank, q, patch_valid), None
    k = (bank if bank is not None
         else _ray_keys(params, config, rays_ori, rays_dir, rays_rgb))
    logits = (q.float() @ k.float().T) / math.sqrt(q.shape[-1])  # [P, R]
    attention = softmax_over_rays(logits, axis_name)
    scores = torch.where(patch_valid[:, None], attention, 0.0).sum(dim=0)
    return scores, attention


def softmax_over_rays(logits, axis_name: str | None = None):
    """The softmax of ``logits`` [P, R] over the ray axis, differentiated
    as ``jax.nn.softmax`` is (the row maximum carries no gradient): one
    ``torch.softmax`` of the rows at hand.

    With ``axis_name`` the rays are this rank's shard of a mesh axis
    (``parallel.mesh``), and the shard's softmax is scaled by its share of
    the whole set's denominator: the local sum ``exp(logsumexp - m)``
    against the maximum ``m`` over the ranks (``pmax``, no gradient),
    divided by its differentiable ``psum``. The result is the full
    softmax's columns, ``exp(logits - m) / psum``, as JAX computes them.
    A one-rank axis's shard is the whole set, so its softmax is the one
    without an axis, gradients included."""
    attention = torch.softmax(logits, dim=-1)
    if axis_name is None or mesh_of(axis_name).size == 1:
        return attention
    m = pmax(logits.detach().amax(dim=-1), axis_name)
    part = torch.exp(torch.logsumexp(logits, dim=-1) - m)
    return attention * (part / psum(part, axis_name))[:, None]


def run_attention(params, config: IDConfig, img, mask, rays_ori, rays_dir,
                  rays_rgb):
    """-> (scores [N_rays], attention [P, N_rays], patch_valid [P],
    features_img [P, D])."""
    q, patch_valid, feats = image_queries(params, config, img, mask)
    scores, attention = score_rays(
        params, config, q, patch_valid, rays_ori, rays_dir, rays_rgb
    )
    return scores, attention, patch_valid, feats


def test_image(params, config: IDConfig, img, mask, rays_ori, rays_dir,
               rays_rgb, rays_to_output: int = 100):
    """Top-k candidate rays for one image
    (identification_module.py:193-209)."""
    scores, attention, patch_valid, _ = run_attention(
        params, config, img, mask, rays_ori, rays_dir, rays_rgb
    )
    from iffnerf_tpu_torch.ops.topk import exact_topk

    values, indices = exact_topk(scores, rays_to_output)
    return indices, values, scores, attention, patch_valid


# keep pytest from collecting the port function above as a test
test_image.__test__ = False


# ---------------------------------------------------------------------------
# Loss (pose_estimation/loss.py:87-146)
# ---------------------------------------------------------------------------


def distance_based_score_target(camera_pose, rays_ori, rays_dir,
                                tanh_denominator: float = 1.0):
    """Per-ray target: 1 - tanh(point-line distance of the GT camera center
    from the ray), clamped to the origin for rays pointing away."""
    cam_pos = camera_pose[:3, 3]
    v = cam_pos[None, :] - rays_ori
    proj = (v * rays_dir).sum(dim=-1, keepdim=True)
    closest = torch.where(proj < 0, rays_ori, rays_ori + proj * rays_dir)
    distance = torch.linalg.norm(closest - cam_pos, dim=-1)
    return 1.0 - torch.tanh(distance / tanh_denominator)


def distance_based_score_loss(pred_score, camera_pose, rays_ori, rays_dir,
                              total_number_of_features,
                              axis_name: str | None = None,
                              n_rays: int | None = None):
    """MSE against the normalized target (sum of target = n_valid_patches).
    Returns (loss, target).

    With ``axis_name`` the rays are this rank's shard of ``n_rays`` on a
    mesh axis: the target's sum runs over the whole set (``psum``) and the
    loss is this rank's part of the whole set's mse, its sum of squares
    over ``n_rays`` (the parts sum to the mse over the ranks)."""
    target = distance_based_score_target(camera_pose, rays_ori, rays_dir)
    total = target.sum()
    if axis_name is not None:
        total = psum(total, axis_name)
    target = (target * (total_number_of_features / total)).detach()
    n = pred_score.shape[0] if n_rays is None else n_rays
    return torch.square(pred_score - target).sum() / n, target
