"""Mip-NeRF-360 (COLMAP sparse) loader (reference dataLoader/mip360.py:28-313).

Parity: PINHOLE/SIMPLE_PINHOLE intrinsics only, poses recentered via the
camera-plane fit + optical-axis intersection and rescaled by the max point
extent, hold-out-every-8 split, bbox ±1, near/far [0.01, 1.4], black bg,
7-channel rays with mip radii.

The geometry (``normalize_scene``, ``mip360_split``, ``mip360_rays``) is
apart from the file reads, so that a scene's cameras and rays can be made
without its files.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from iffnerf_tpu_torch.data.base import RayDataset, load_image, stack_or_flatten
from iffnerf_tpu_torch.data.colmap import (
    qvec2rotmat,
    read_extrinsics_binary,
    read_extrinsics_text,
    read_intrinsics_binary,
    read_intrinsics_text,
    read_points3D_binary,
    read_points3D_text,
)
from iffnerf_tpu_torch.data.pose_utils import recenter_poses, rescale_poses
from iffnerf_tpu_torch.data.rays_np import ray_directions_Ks_np, rays_with_radii_np

SCENE_BBOX = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
NEAR_FAR = (0.01, 1.4)


def read_colmap_cameras(cam_extrinsics, cam_intrinsics, images_folder: str,
                        resize_factor: float = 1.0):
    """(reference mip360.py:28-86)"""
    cams = []
    for key in cam_extrinsics:
        extr = cam_extrinsics[key]
        intr = cam_intrinsics[extr.camera_id]
        if intr.model == "SIMPLE_PINHOLE":
            fx = fy = intr.params[0]
            cx, cy = intr.params[1], intr.params[2]
        elif intr.model == "PINHOLE":
            fx, fy, cx, cy = intr.params[:4]
        else:
            raise ValueError(
                "Only undistorted PINHOLE/SIMPLE_PINHOLE models supported"
            )
        K = np.array(
            [[fx / resize_factor, 0, cx / resize_factor],
             [0, fy / resize_factor, cy / resize_factor],
             [0, 0, 1]]
        )
        w2c = np.eye(4)
        w2c[:3, :3] = qvec2rotmat(extr.qvec)
        w2c[:3, 3] = extr.tvec
        cams.append({
            "uid": intr.id,
            "K": K,
            "cam2world": np.linalg.inv(w2c),
            "image_filename": os.path.join(
                images_folder, os.path.basename(extr.name)
            ),
        })
    return sorted(cams, key=lambda c: c["uid"])


def normalize_scene(cam2worlds: np.ndarray, xyz: np.ndarray):
    """Recentre the cameras [N, 4, 4] and scale them by the largest extent
    of the recentred point cloud xyz [P, 3] -> (cam2worlds, inv_scale,
    inv_transformation) (reference mip360.py:125-142)."""
    cam2worlds, inv_transformation = recenter_poses(cam2worlds)
    pcd = np.concatenate([xyz, np.ones((len(xyz), 1))], -1)
    centered = np.linalg.inv(inv_transformation) @ pcd.T
    max_size = np.abs(centered).max(axis=0).max()
    cam2worlds, inv_scale = rescale_poses(cam2worlds, max_size)
    return cam2worlds, inv_scale, inv_transformation


def read_annotations(data_dir: str, resize_factor: float = 1.0):
    """(reference mip360.py:89-142)"""
    sparse = os.path.join(data_dir, "sparse/0")
    try:
        extr = read_extrinsics_binary(os.path.join(sparse, "images.bin"))
        intr = read_intrinsics_binary(os.path.join(sparse, "cameras.bin"))
    except (OSError, struct.error):
        extr = read_extrinsics_text(os.path.join(sparse, "images.txt"))
        intr = read_intrinsics_text(os.path.join(sparse, "cameras.txt"))
    cams = read_colmap_cameras(
        extr, intr, os.path.join(data_dir, "images"), resize_factor
    )
    try:
        xyz, _, _ = read_points3D_binary(os.path.join(sparse, "points3D.bin"))
    except OSError:
        xyz, _, _ = read_points3D_text(os.path.join(sparse, "points3D.txt"))

    cam2worlds = np.stack([c["cam2world"] for c in cams])
    intrinsics = np.stack([c["K"] for c in cams])
    filenames = [c["image_filename"] for c in cams]
    cam2worlds, inv_scale, inv_transformation = normalize_scene(cam2worlds,
                                                                xyz)
    return cam2worlds, intrinsics, filenames, inv_scale, inv_transformation


def mip360_split(n_images: int, split: str, hold_every: int = 8):
    """Every ``hold_every``-th image is a test image, the rest train."""
    idx_all = np.arange(n_images)
    if split == "train":
        return idx_all[idx_all % hold_every != 0]
    return idx_all[idx_all % hold_every == 0]


def mip360_camera(K: np.ndarray, img_wh):
    """K [1, 3, 3] float32 at the image size img_wh -> (unit directions,
    the unnormalised directions and their pixel neighbours dx, dy), each
    [h, w, 3]."""
    w, h = img_wh
    ori_dirs, dx, dy = ray_directions_Ks_np(h, w, K)
    ori_dirs, dx, dy = ori_dirs[0], dx[0], dy[0]
    directions = ori_dirs / np.linalg.norm(ori_dirs, axis=-1, keepdims=True)
    return directions, ori_dirs, dx, dy


def mip360_rays(camera, c2w) -> np.ndarray:
    """An image's rays with mip radii [h, w, 7] float32 from
    ``mip360_camera``'s output and its c2w [4, 4] (float32)."""
    directions, ori_dirs, dx, dy = camera
    rays_o, rays_d, radii = rays_with_radii_np(
        directions, c2w, directions=ori_dirs, dx=dx, dy=dy, keepdim=True
    )
    return np.concatenate([rays_o, rays_d, radii], -1).astype(np.float32)


def load_mip360(datadir: str, split: str = "train", downsample: float = 4.0,
                is_stack: bool = False, hold_every: int = 8, N_vis: int = -1,
                **kwargs) -> RayDataset:
    cam2worlds, intrinsics, filenames, _, _ = read_annotations(
        datadir, resize_factor=downsample
    )
    sel = mip360_split(len(cam2worlds), split, hold_every)

    from PIL import Image

    with Image.open(filenames[sel[0]]) as im:
        base_w, base_h = im.size
    img_wh = (int(base_w / downsample), int(base_h / downsample)) \
        if downsample != 1.0 else (base_w, base_h)
    w, h = img_wh

    K = intrinsics[sel[0]][None].astype(np.float32)
    camera = mip360_camera(K, img_wh)

    interval = 1 if N_vis < 0 else max(len(sel) // N_vis, 1)
    poses, rays_list, rgbs_list = [], [], []
    for i in sel[::interval]:
        c2w = cam2worlds[i].astype(np.float32)
        poses.append(c2w)
        img = load_image(filenames[i], img_wh)
        rgbs_list.append(img.reshape(h, w, -1)[..., :3])
        rays_list.append(mip360_rays(camera, c2w))

    all_rays, all_rgbs = stack_or_flatten(rays_list, rgbs_list, is_stack)
    return RayDataset(
        all_rays=all_rays, all_rgbs=all_rgbs, poses=np.stack(poses), K=K,
        scene_bbox=SCENE_BBOX.copy(), near_far=NEAR_FAR, white_bg=False,
        img_wh=img_wh, is_stack=is_stack, split=split, downsample=downsample,
        directions=np.asarray(camera[0], np.float32),
    )
