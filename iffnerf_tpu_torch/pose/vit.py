"""DINOv2-style ViT-S/14 image backbone on parameter dicts.

The forward matches DINOv2's ``forward_features`` and returns
``x_norm_patchtokens`` [N_patches, D]: patch embedding as a reshape plus
one matmul (weights ``[p, p, 3, D]``), cls token and position embedding,
pre-norm blocks with LayerScale, final LayerNorm, cls token dropped.
LayerNorm uses the biased variance with eps 1e-6 and GELU is the exact
erf form.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: int = 224
    patch_size: int = 14
    dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: int = 4
    layerscale_init: float = 1e-5

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def n_patches(self) -> int:
        return self.grid * self.grid


def _trunc_normal(gen, shape, std=0.02):
    t = torch.empty(shape)
    return torch.nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std,
                                       generator=gen)


def init_vit(gen: torch.Generator, config: ViTConfig = ViTConfig()):
    d = config.dim
    h = d * config.mlp_ratio

    def norm():
        return {"scale": torch.ones(d), "bias": torch.zeros(d)}

    params = {
        "patch_embed": {
            "w": _trunc_normal(gen, (config.patch_size, config.patch_size,
                                     3, d)),
            "b": torch.zeros(d),
        },
        "cls_token": _trunc_normal(gen, (1, d), std=1e-6),
        "pos_embed": _trunc_normal(gen, (1 + config.n_patches, d)),
        "norm": norm(),
    }
    params["blocks"] = tuple(
        {
            "norm1": norm(),
            "qkv": {"w": _trunc_normal(gen, (d, 3 * d)),
                    "b": torch.zeros(3 * d)},
            "proj": {"w": _trunc_normal(gen, (d, d)), "b": torch.zeros(d)},
            "ls1": torch.full((d,), config.layerscale_init),
            "norm2": norm(),
            "fc1": {"w": _trunc_normal(gen, (d, h)), "b": torch.zeros(h)},
            "fc2": {"w": _trunc_normal(gen, (h, d)), "b": torch.zeros(d)},
            "ls2": torch.full((d,), config.layerscale_init),
        }
        for _ in range(config.depth)
    )
    return params


def _layer_norm(p, x, eps=1e-6):
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def _attention(block, x, num_heads: int):
    n, d = x.shape
    head = d // num_heads
    qkv = x @ block["qkv"]["w"] + block["qkv"]["b"]
    q, k, v = (t.reshape(n, num_heads, head).transpose(0, 1)
               for t in qkv.split(d, dim=-1))
    attn = torch.softmax((q @ k.transpose(1, 2)) / math.sqrt(head), dim=-1)
    out = (attn @ v).transpose(0, 1).reshape(n, d)
    return out @ block["proj"]["w"] + block["proj"]["b"]


def _mlp(block, x):
    h = F.gelu(x @ block["fc1"]["w"] + block["fc1"]["b"])
    return h @ block["fc2"]["w"] + block["fc2"]["b"]


def vit_forward_features(params, img: torch.Tensor,
                         config: ViTConfig = ViTConfig()) -> torch.Tensor:
    """img [H, W, 3] (normalized) -> x_norm_patchtokens [n_patches, dim]."""
    g, p = config.grid, config.patch_size
    x = img.reshape(g, p, g, p, 3).permute(0, 2, 1, 3, 4).reshape(
        g * g, p * p * 3
    )
    w = params["patch_embed"]["w"].reshape(p * p * 3, config.dim)
    x = x @ w + params["patch_embed"]["b"]

    x = torch.cat([params["cls_token"], x], dim=0)
    x = x + params["pos_embed"]

    for block in params["blocks"]:
        x = x + block["ls1"] * _attention(
            block, _layer_norm(block["norm1"], x), config.num_heads
        )
        x = x + block["ls2"] * _mlp(block, _layer_norm(block["norm2"], x))

    x = _layer_norm(params["norm"], x)
    return x[1:]


def convert_torch_dinov2(state_dict, config: ViTConfig = ViTConfig()):
    """Maps a torch-hub DINOv2 ``state_dict`` (facebookresearch/dinov2
    naming) into this module's parameter dict, as the JAX package's
    ``convert_torch_dinov2`` maps it into its pytree: linear weights
    transposed to [in, out], the patch convolution [D, 3, p, p] to [p, p,
    3, D], the tokens' batch axis dropped; float32 CPU tensors.
    ``tools/convert_dinov2.py`` writes the result with
    ``checkpoint.save_pytree``."""
    sd = {k: torch.as_tensor(v).detach().to("cpu", torch.float32)
          for k, v in state_dict.items()}

    def lin(prefix):
        return {"w": sd[f"{prefix}.weight"].T.contiguous(),
                "b": sd[f"{prefix}.bias"]}

    def norm(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    params = {
        "patch_embed": {
            "w": sd["patch_embed.proj.weight"].permute(2, 3, 1, 0).contiguous(),
            "b": sd["patch_embed.proj.bias"],
        },
        "cls_token": sd["cls_token"][0],
        "pos_embed": sd["pos_embed"][0],
        "norm": norm("norm"),
    }
    params["blocks"] = tuple(
        {"norm1": norm(f"blocks.{i}.norm1"),
         "qkv": lin(f"blocks.{i}.attn.qkv"),
         "proj": lin(f"blocks.{i}.attn.proj"),
         "ls1": sd[f"blocks.{i}.ls1.gamma"],
         "norm2": norm(f"blocks.{i}.norm2"),
         "fc1": lin(f"blocks.{i}.mlp.fc1"),
         "fc2": lin(f"blocks.{i}.mlp.fc2"),
         "ls2": sd[f"blocks.{i}.ls2.gamma"]}
        for i in range(config.depth))
    return params
