"""Tanks&Temples (NSVF layout) loader (reference dataLoader/tankstemple.py:92-300).

Parity: bbox.txt x 1.2, near/far [0.01, 6], intrinsics.txt / downsample,
0_/1_/2_ split prefixes, white-distance mask synthesized for RGB images
(:193-197), 7-channel rays with mip radii, circular render path around the
camera centroid (:213-257)."""

from __future__ import annotations

import math
import os

import numpy as np

from iffnerf_tpu_torch.data.base import RayDataset, load_image, stack_or_flatten
from iffnerf_tpu_torch.data.nsvf import _split_files
from iffnerf_tpu_torch.data.rays_np import ray_directions_Ks_np, rays_with_radii_np


def make_look_at(camera_position, target, up) -> np.ndarray:
    """Opencv-convention look-at c2w (reference dataLoader/spiral_utils.py)."""
    z = target - camera_position
    z = z / np.linalg.norm(z)
    x = np.cross(z, -up)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = x, y, z
    c2w[:3, 3] = camera_position
    return c2w


def load_tankstemple(datadir: str, split: str = "train",
                     downsample: float = 1.0, is_stack: bool = False,
                     ori_wh=(1920, 1080), **kwargs) -> RayDataset:
    img_wh = (int(ori_wh[0] / downsample), int(ori_wh[1] / downsample))
    w, h = img_wh

    K = np.loadtxt(os.path.join(datadir, "intrinsics.txt")).astype(
        np.float32
    )[:3, :3]
    K[:2] /= downsample
    K = K[None]

    scene_bbox = (
        np.loadtxt(os.path.join(datadir, "bbox.txt")).astype(np.float32)[:6]
        .reshape(2, 3) * 1.2
    )

    pose_files = _split_files(datadir, "pose", split)
    img_files = _split_files(datadir, "rgb", split)
    assert len(pose_files) == len(img_files)

    ori_dirs, dx, dy = ray_directions_Ks_np(h, w, K)
    ori_dirs, dx, dy = ori_dirs[0], dx[0], dy[0]
    directions = ori_dirs / np.linalg.norm(ori_dirs, axis=-1, keepdims=True)

    poses, rays_list, rgbs_list = [], [], []
    for img_f, pose_f in zip(img_files, pose_files):
        c2w = np.loadtxt(os.path.join(datadir, "pose", pose_f)).astype(
            np.float32
        )
        poses.append(c2w)

        img = load_image(
            os.path.join(datadir, "rgb", img_f),
            img_wh if downsample != 1.0 else None,
        ).reshape(h, w, -1)
        if img.shape[-1] == 3:
            # synthesize an object mask from distance-to-white (:193-197)
            distance = np.linalg.norm(img - 1.0, axis=-1)
            mask = (~(distance < 5.0 / 255.0)).astype(img.dtype)
            img = np.concatenate([img, mask[..., None]], axis=-1)
        rgbs_list.append(img)

        rays_o, rays_d, radii = rays_with_radii_np(
            directions, c2w, directions=ori_dirs, dx=dx, dy=dy, keepdim=True
        )
        rays_list.append(
            np.concatenate([rays_o, rays_d, radii], -1).astype(np.float32)
        )

    poses = np.stack(poses)
    all_rays, all_rgbs = stack_or_flatten(rays_list, rgbs_list, is_stack)

    # circular render path at the camera-centroid height (:228-257)
    cam_points = poses[:, :3, 3]
    center_point = (scene_bbox[0] + scene_bbox[1]) / 2.0
    avg_dist = np.mean(np.linalg.norm(cam_points - center_point, axis=-1))
    up = poses[:, :3, 1].sum(0)
    up = up / np.linalg.norm(up)
    theta = np.linspace(0, 2 * math.pi, 100)
    r = avg_dist * 1.4
    z_mean = cam_points.mean(0)[-1]
    positions = np.stack(
        [r * np.sin(theta), np.full(100, z_mean), r * np.cos(theta)], axis=-1
    ) + center_point
    render_path = np.stack(
        [make_look_at(p.astype(np.float32), center_point, up)
         for p in positions]
    )

    return RayDataset(
        all_rays=all_rays, all_rgbs=all_rgbs, poses=poses, K=K,
        scene_bbox=scene_bbox, near_far=(0.01, 6.0), white_bg=True,
        img_wh=img_wh, is_stack=is_stack, split=split,
        downsample=downsample, directions=np.asarray(directions, np.float32),
        render_path=render_path,
    )
