"""colmap2nerf-style json loader (reference dataLoader/your_own_data.py:13-129).

Parity: per-axis focal from camera_angle_x/y + explicit cx/cy, normalized
opencv-convention dirs, RGBA blended to white at load, 6-channel rays,
bbox ±1.5, near/far [0.1, 100]."""

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
from iffnerf_tpu_torch.data.rays_np import ray_directions_np, rays_simple_np


def load_your_own(datadir: str, split: str = "train",
                  downsample: float = 1.0, is_stack: bool = False,
                  N_vis: int = -1, **kwargs) -> RayDataset:
    with open(os.path.join(datadir, f"transforms_{split}.json")) as f:
        meta = json.load(f)

    w = int(meta["w"] / downsample)
    h = int(meta["h"] / downsample)
    focal_x = 0.5 * w / np.tan(0.5 * meta["camera_angle_x"])
    focal_y = 0.5 * h / np.tan(0.5 * meta["camera_angle_y"])
    cx, cy = meta["cx"], meta["cy"]

    directions = ray_directions_np(
        h, w, [focal_x, focal_y], center=[cx, cy], blender=False
    )
    directions = directions / np.linalg.norm(
        directions, axis=-1, keepdims=True
    )
    K = np.array(
        [[[focal_x, 0, cx], [0, focal_y, cy], [0, 0, 1]]], np.float32
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
            (w, h) if downsample != 1.0 else None,
        ).reshape(h, w, -1)
        if img.shape[-1] == 4:
            img = img[..., :3] * img[..., -1:] + (1 - img[..., -1:])
        rgbs_list.append(img)

        rays_o, rays_d = rays_simple_np(directions, c2w)
        rays_list.append(
            np.concatenate([rays_o, rays_d], -1).reshape(h, w, 6)
            .astype(np.float32)
        )

    all_rays, all_rgbs = stack_or_flatten(rays_list, rgbs_list, is_stack)
    return RayDataset(
        all_rays=all_rays, all_rgbs=all_rgbs, poses=np.stack(poses), K=K,
        scene_bbox=np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]],
                            np.float32),
        near_far=(0.1, 100.0), white_bg=True, img_wh=(w, h),
        is_stack=is_stack, split=split, downsample=downsample,
        directions=np.asarray(directions, np.float32),
    )
