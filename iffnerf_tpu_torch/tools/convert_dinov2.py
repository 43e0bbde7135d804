"""Offline DINOv2 ViT-S/14 weight converter of the port.

Turns a torch-hub DINOv2 checkpoint (facebookresearch/dinov2 naming, e.g.
``dinov2_vits14_pretrain.pth`` from a torch.hub cache) into the npz that
``pose_cli --backbone_ckpt`` loads, through ``pose.vit.convert_torch_dinov2``
and ``checkpoint.save_pytree``. Nothing is downloaded; the JAX package's
HuggingFace route (``--hf``) needs ``transformers`` and is not ported.

    python -m iffnerf_tpu_torch.tools.convert_dinov2 \\
        --torch_ckpt dinov2_vits14_pretrain.pth --out dinov2_vits14.npz
"""

from __future__ import annotations

import argparse

import torch

from iffnerf_tpu_torch.checkpoint import save_pytree
from iffnerf_tpu_torch.pose.vit import ViTConfig, convert_torch_dinov2


def load_state_dict(path: str) -> dict:
    """The state dict of a torch checkpoint: a plain dict, a module, or a
    dict holding it under ``model``."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return sd


def block_count(sd: dict) -> int:
    """The number of transformer blocks in a torch-hub state dict."""
    depth = 0
    while f"blocks.{depth}.norm1.weight" in sd:
        depth += 1
    return depth


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--torch_ckpt", type=str, required=True,
                    help="torch-hub DINOv2 checkpoint (.pth)")
    ap.add_argument("--out", type=str, required=True, help="npz to write")
    args = ap.parse_args(argv)
    sd = load_state_dict(args.torch_ckpt)
    params = convert_torch_dinov2(sd, ViTConfig(depth=block_count(sd)))
    save_pytree(args.out, params, {"arch": "dinov2_vits14"})
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
