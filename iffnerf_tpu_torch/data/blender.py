"""NeRF-synthetic (Blender ``transforms_*.json``) loader
(reference dataLoader/blender.py:14-158).

RGBA is kept un-premultiplied (:100-103); rays carry mip-NeRF radii as
the 7th channel, computed from the unnormalized neighbour directions
while ray dirs are normalized (:69-72,105-114); poses are converted
blender -> opencv (:33-35,90); bbox +-1.5, near/far [2, 6], white
background.
"""

from __future__ import annotations

import json
import os

import numpy as np

from iffnerf_tpu_torch.data.base import (
    BLENDER2OPENCV,
    RayDataset,
    load_image,
    stack_or_flatten,
)
from iffnerf_tpu_torch.data.rays_np import ray_directions_Ks_np, rays_with_radii_np


def load_blender(datadir: str, split: str = "train", downsample: float = 1.0,
                 is_stack: bool = False, N_vis: int = -1, **kwargs) -> RayDataset:
    with open(os.path.join(datadir, f"transforms_{split}.json")) as f:
        meta = json.load(f)

    # the base resolution comes from the first image (the reference
    # hardcodes 800, blender.py:28,57-62), so small fixtures load too
    first = os.path.join(datadir, meta["frames"][0]["file_path"] + ".png")
    from PIL import Image

    with Image.open(first) as im:
        base_w, base_h = im.size
    w, h = int(base_w / downsample), int(base_h / downsample)
    img_wh = (w, h)

    focal = 0.5 * base_w / np.tan(0.5 * meta["camera_angle_x"])
    focal *= w / base_w

    K = np.array(
        [[[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]]], dtype=np.float32
    )
    ori_directions, dx, dy = ray_directions_Ks_np(h, w, K)
    ori_directions, dx, dy = ori_directions[0], dx[0], dy[0]
    directions = ori_directions / np.linalg.norm(
        ori_directions, axis=-1, keepdims=True
    )

    n_frames = len(meta["frames"])
    interval = 1 if N_vis < 0 else max(n_frames // N_vis, 1)

    poses, rays_list, rgbs_list = [], [], []
    for i in range(0, n_frames, interval):
        frame = meta["frames"][i]
        c2w = (np.array(frame["transform_matrix"]) @ BLENDER2OPENCV).astype(
            np.float32
        )
        poses.append(c2w)
        img = load_image(
            os.path.join(datadir, frame["file_path"] + ".png"),
            img_wh if downsample != 1.0 else None,
        )
        rgbs_list.append(img.reshape(h, w, -1))
        rays_o, rays_d, radii = rays_with_radii_np(
            directions, c2w, directions=ori_directions, dx=dx, dy=dy,
            keepdim=True,
        )
        rays_list.append(
            np.concatenate([rays_o, rays_d, radii], axis=-1).astype(np.float32)
        )

    all_rays, all_rgbs = stack_or_flatten(rays_list, rgbs_list, is_stack)
    return RayDataset(
        all_rays=all_rays,
        all_rgbs=all_rgbs,
        poses=np.stack(poses),
        K=K,
        scene_bbox=np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32),
        near_far=(2.0, 6.0),
        white_bg=True,
        img_wh=img_wh,
        is_stack=is_stack,
        split=split,
        downsample=downsample,
        directions=np.asarray(directions, np.float32),
    )
