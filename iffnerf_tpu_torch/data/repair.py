"""Metashape-XML scene loader ("repair" dataset,
reference dataLoader/repair.py:23-209 + repair_camera_parser.py).

Parity: cameras.xml poses (recentered + rescaled), undistorted images with
masks from ``masks/``, hold-every-10 test split, bbox [[-1,-1,0],[1,1,1]],
near/far [0.1, 1.8], white bg, per-image intrinsics (each camera carries its
own K), 7-channel rays with mip radii.

The geometry (``repair_split``, ``homogeneous``, ``repair_rays``,
``spiral_path``) is apart from the image reads, so that a capture's rays
can be made from its ``cameras.xml`` alone.
"""

from __future__ import annotations

import os

import numpy as np

from iffnerf_tpu_torch.data.base import RayDataset, load_image, stack_or_flatten
from iffnerf_tpu_torch.data.metashape import load_cameras_xml
from iffnerf_tpu_torch.data.rays_np import ray_directions_Ks_np, rays_with_radii_np
from iffnerf_tpu_torch.data.spiral import create_spiral

VAL_SPLIT_EVERY = 10
SCENE_BBOX = np.array([[-1.0, -1.0, 0.0], [1.0, 1.0, 1.0]], np.float32)
NEAR_FAR = (0.1, 1.8)


def repair_split(n_images: int, split: str) -> list:
    """Every VAL_SPLIT_EVERY-th camera is a test camera, the rest train."""
    val_idx = set(range(0, n_images, VAL_SPLIT_EVERY))
    if split == "test":
        return sorted(val_idx)
    return [i for i in range(n_images) if i not in val_idx]


def homogeneous(c2w: np.ndarray) -> np.ndarray:
    """A float32 c2w [3|4, 4] as [4, 4]."""
    c2w = c2w.astype(np.float32)
    if c2w.shape[0] == 3:
        return np.concatenate([c2w, np.array([[0, 0, 0, 1]], np.float32)], 0)
    return c2w


def repair_rays(K: np.ndarray, c2w: np.ndarray, img_wh) -> np.ndarray:
    """An image's rays with mip radii [h, w, 7] float32 from its camera's
    K [3, 3] and c2w [4, 4] at the image size img_wh."""
    w, h = img_wh
    ori_dirs, dx, dy = ray_directions_Ks_np(h, w, K[None])
    ori_dirs, dx, dy = ori_dirs[0], dx[0], dy[0]
    dirs = ori_dirs / np.linalg.norm(ori_dirs, axis=-1, keepdims=True)
    rays_o, rays_d, radii = rays_with_radii_np(
        dirs, c2w, directions=ori_dirs, dx=dx, dy=dy, keepdim=True
    )
    return np.concatenate([rays_o, rays_d, radii], -1).astype(np.float32)


def spiral_path(scene_bbox: np.ndarray, poses: np.ndarray) -> np.ndarray:
    """``create_spiral``'s 100 poses over the box, up the cameras' mean
    up direction."""
    up = poses[:, :3, 1].sum(0)
    up = up / np.linalg.norm(up)
    return create_spiral(scene_bbox, up, invert_z=False)


def load_repair(datadir: str, split: str = "train", downsample: float = 1.0,
                is_stack: bool = False, **kwargs) -> RayDataset:
    cameras, _, _ = load_cameras_xml(
        os.path.join(datadir, "cameras.xml"), datadir,
        img_resize_factor=downsample, img_dirname="undistorted_images",
    )
    if not cameras:
        raise FileNotFoundError(f"no usable cameras.xml under {datadir}")

    sel = repair_split(len(cameras["filenames"]), split)
    poses, rays_list, rgbs_list = [], [], []
    img_wh = None
    for i in sel:
        img = load_image(cameras["filenames"][i])
        h, w = img.shape[:2]
        if downsample != 1.0:
            img = load_image(
                cameras["filenames"][i],
                (int(w / downsample), int(h / downsample)),
            )
            h, w = img.shape[:2]
        img_wh = (w, h)

        mask_path = os.path.join(
            datadir, "masks", os.path.basename(cameras["filenames"][i])
        )
        if os.path.exists(mask_path):
            m = load_image(mask_path, (w, h))
            mask = np.ceil(m[..., :1])
        else:
            mask = np.ones((h, w, 1), np.float32)
        rgbs_list.append(np.concatenate([img[..., :3], mask], axis=-1))

        poses.append(homogeneous(cameras["cam2world"][i]))
        rays_list.append(repair_rays(cameras["Ks"][i], poses[-1], img_wh))

    all_rays, all_rgbs = stack_or_flatten(rays_list, rgbs_list, is_stack)
    poses_np = np.stack(poses)
    return RayDataset(
        all_rays=all_rays, all_rgbs=all_rgbs, poses=poses_np,
        K=cameras["Ks"][sel[0]][None].astype(np.float32),
        scene_bbox=SCENE_BBOX.copy(),
        near_far=NEAR_FAR, white_bg=True, img_wh=img_wh,
        is_stack=is_stack, split=split, downsample=downsample,
        render_path=spiral_path(SCENE_BBOX, poses_np),
    )
