"""NSVF synthetic loader (reference dataLoader/nsvf.py:36-160).

Parity: RGBA blended to white at load (:107), 6-channel rays (no mip
radii), bbox from bbox.txt, near/far [0.5, 6], spherical render path
(:29-34, :92). Tanks&Temples shares its split rule (``_split_files``)."""

from __future__ import annotations

import os

import numpy as np

from iffnerf_tpu_torch.data.base import RayDataset, load_image, stack_or_flatten
from iffnerf_tpu_torch.data.rays_np import ray_directions_np, rays_simple_np


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """(reference nsvf.py:10-34)"""
    c2w = np.eye(4)
    c2w[2, 3] = radius
    def rot_phi(p):
        m = np.eye(4)
        m[1, 1], m[1, 2] = np.cos(p), -np.sin(p)
        m[2, 1], m[2, 2] = np.sin(p), np.cos(p)
        return m
    def rot_theta(t):
        m = np.eye(4)
        m[0, 0], m[0, 2] = np.cos(t), -np.sin(t)
        m[2, 0], m[2, 2] = np.sin(t), np.cos(t)
        return m
    c2w = rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = rot_theta(theta / 180.0 * np.pi) @ c2w
    flip = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
        dtype=np.float64,
    )
    return (flip @ c2w).astype(np.float32)


def _split_files(root: str, sub: str, split: str):
    """Sorted files of ``root/sub`` for a split: ``0_`` train, ``1_`` val,
    ``2_`` test (``1_`` when a scene has no ``2_``)."""
    files = sorted(os.listdir(os.path.join(root, sub)))
    prefix = {"train": "0_", "val": "1_"}.get(split)
    if prefix is not None:
        return [f for f in files if f.startswith(prefix)]
    test = [f for f in files if f.startswith("2_")]
    if not test:
        test = [f for f in files if f.startswith("1_")]
    return test


def load_nsvf(datadir: str, split: str = "train", downsample: float = 1.0,
              is_stack: bool = False, wh=(800, 800), **kwargs) -> RayDataset:
    img_wh = (int(wh[0] / downsample), int(wh[1] / downsample))
    w, h = img_wh

    with open(os.path.join(datadir, "intrinsics.txt")) as f:
        focal = float(f.readline().split()[0])
    K = np.array(
        [[focal, 0, 400.0], [0, focal, 400.0], [0, 0, 1]], dtype=np.float64
    )
    K[:2] *= (np.asarray(img_wh) / np.array([800.0, 800.0])).reshape(2, 1)
    K = K.astype(np.float32)

    scene_bbox = np.loadtxt(os.path.join(datadir, "bbox.txt")).astype(
        np.float32
    )[:6].reshape(2, 3)

    pose_files = _split_files(datadir, "pose", split)
    img_files = _split_files(datadir, "rgb", split)
    if len(pose_files) != len(img_files):
        raise ValueError(f"{len(pose_files)} poses and {len(img_files)} images "
                         f"in the {split} split")

    directions = ray_directions_np(
        h, w, [K[0, 0], K[1, 1]], center=K[:2, 2], blender=False
    )
    directions = directions / np.linalg.norm(
        directions, axis=-1, keepdims=True
    )

    poses, rays_list, rgbs_list = [], [], []
    for img_f, pose_f in zip(img_files, pose_files):
        img = load_image(
            os.path.join(datadir, "rgb", img_f),
            img_wh if downsample != 1.0 else None,
        )
        if img.shape[-1] == 4:
            img = img[..., :3] * img[..., -1:] + (1 - img[..., -1:])
        rgbs_list.append(img.reshape(h, w, 3))

        c2w = np.loadtxt(os.path.join(datadir, "pose", pose_f)).astype(
            np.float32
        )
        poses.append(c2w)
        rays_o, rays_d = rays_simple_np(directions, c2w)
        rays_list.append(
            np.concatenate([rays_o, rays_d], -1).reshape(h, w, 6)
        )

    all_rays, all_rgbs = stack_or_flatten(rays_list, rgbs_list, is_stack)
    render_path = np.stack(
        [pose_spherical(a, -30.0, 4.0)
         for a in np.linspace(-180, 180, 41)[:-1]]
    )

    return RayDataset(
        all_rays=all_rays, all_rgbs=all_rgbs, poses=np.stack(poses),
        K=K[None], scene_bbox=scene_bbox, near_far=(0.5, 6.0),
        white_bg=True, img_wh=img_wh, is_stack=is_stack, split=split,
        downsample=downsample, directions=np.asarray(directions, np.float32),
        render_path=render_path,
    )
