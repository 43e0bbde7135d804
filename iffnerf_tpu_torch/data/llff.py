"""LLFF forward-facing loader (reference dataLoader/llff.py:122-242).

Parity: poses_bounds.npy (down-right-back -> right-up-back axis fix),
pose centering by the average pose, near-plane rescale (near*0.75), NDC
rays, hold-every-8 test split, spiral render path, bbox
[[-1.5,-1.67,-1],[1.5,1.67,1]], near/far [0,1], black bg.

The geometry (``llff_cameras``, ``llff_split``, ``llff_rays``) is apart
from the image reads, so that a scene's cameras and rays can be made
without its image files.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from iffnerf_tpu_torch.data.base import RayDataset, load_image, stack_or_flatten
from iffnerf_tpu_torch.data.rays_np import (
    ndc_rays_blender_np,
    ray_directions_np,
    rays_simple_np,
)

SCENE_BBOX = np.array([[-1.5, -1.67, -1.0], [1.5, 1.67, 1.0]], np.float32)


def _normalize(v):
    return v / np.linalg.norm(v)


def average_poses(poses: np.ndarray) -> np.ndarray:
    """(reference llff.py:17-51)"""
    center = poses[..., 3].mean(0)
    z = _normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = _normalize(np.cross(z, y_))
    y = np.cross(x, z)
    return np.stack([x, y, z, center], 1)


def center_poses(poses: np.ndarray):
    """(reference llff.py:54-78)"""
    pose_avg = average_poses(poses)
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3] = pose_avg
    last_row = np.tile(np.array([0, 0, 0, 1.0]), (len(poses), 1, 1))
    poses_homo = np.concatenate([poses, last_row], 1)
    centered = np.linalg.inv(pose_avg_homo) @ poses_homo
    return centered[:, :3], pose_avg_homo


def _viewmatrix(z, up, pos):
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    m = np.eye(4)
    m[:3] = np.stack([-vec0, vec1, vec2, pos], 1)
    return m


def get_spiral(c2ws_all, near_fars, rads_scale: float = 1.0,
               n_views: int = 120):
    """Spiral render path (reference llff.py:91-119)."""
    c2w = average_poses(c2ws_all)
    up = _normalize(c2ws_all[:, :3, 1].sum(0))
    dt = 0.75
    close_depth = near_fars.min() * 0.9
    inf_depth = near_fars.max() * 5.0
    focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    tt = c2ws_all[:, :3, 3]
    rads = np.append(np.percentile(np.abs(tt), 90, 0) * rads_scale, 1.0)

    poses = []
    for theta in np.linspace(0.0, 2 * np.pi * 2, n_views + 1)[:-1]:
        c = c2w[:3, :4] @ (
            np.array([np.cos(theta), -np.sin(theta),
                      -np.sin(theta * 0.5), 1.0]) * rads
        )
        z = _normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        poses.append(_viewmatrix(z, up, c))
    return np.stack(poses)


def llff_cameras(poses_bounds: np.ndarray, downsample: float = 4.0):
    """poses_bounds [N, 17] (COLMAP's down-right-back poses with their
    h, w, focal column, then near and far) -> (poses [N, 3, 4] centred
    and scaled, near_fars [N, 2] scaled, focal [fx, fy] and img_wh at
    ``downsample``, the 120-pose spiral render path)."""
    poses = poses_bounds[:, :15].reshape(-1, 3, 5)
    near_fars = poses_bounds[:, -2:]

    H, W, focal = poses[0, :, -1]
    img_wh = (int(W / downsample), int(H / downsample))
    focal = [focal * img_wh[0] / W, focal * img_wh[1] / H]

    # down-right-back -> right-up-back (llff.py:170)
    poses = np.concatenate(
        [poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], -1
    )
    poses, _ = center_poses(poses)

    scale_factor = near_fars.min() * 0.75
    near_fars = near_fars / scale_factor
    poses[..., 3] /= scale_factor

    render_path = get_spiral(poses, near_fars, n_views=120)
    return poses, near_fars, focal, img_wh, render_path


def llff_split(n_images: int, split: str, hold_every: int = 8) -> list:
    """Every ``hold_every``-th image is a test image, the rest train."""
    i_test = np.arange(0, n_images, hold_every)
    if split == "train":
        return sorted(set(range(n_images)) - set(i_test.tolist()))
    return i_test.tolist()


def llff_rays(directions, c2w, focal, img_wh) -> np.ndarray:
    """An image's NDC rays [h, w, 6] float32 from the camera-frame
    ``directions`` [h, w, 3] and its c2w [3, 4] (float32)."""
    w, h = img_wh
    rays_o, rays_d = rays_simple_np(directions, c2w)
    rays_o, rays_d = ndc_rays_blender_np(h, w, focal[0], 1.0, rays_o, rays_d)
    return (np.concatenate([rays_o, rays_d], -1).reshape(h, w, 6)
            .astype(np.float32))


def load_llff(datadir: str, split: str = "train", downsample: float = 4.0,
              is_stack: bool = False, hold_every: int = 8, **kwargs
              ) -> RayDataset:
    poses_bounds = np.load(os.path.join(datadir, "poses_bounds.npy"))
    image_paths = sorted(glob.glob(os.path.join(datadir, "images_4/*")))
    if split in ("train", "test") and len(poses_bounds) != len(image_paths):
        raise ValueError("Mismatch between number of images and poses; "
                         "rerun COLMAP")

    poses, _, focal, img_wh, render_path = llff_cameras(poses_bounds,
                                                        downsample)
    w, h = img_wh
    directions = ray_directions_np(h, w, focal, blender=True)

    rays_list, rgbs_list, used_poses = [], [], []
    for i in llff_split(len(poses), split, hold_every):
        c2w = poses[i].astype(np.float32)
        used_poses.append(np.concatenate(
            [c2w, np.array([[0, 0, 0, 1]], np.float32)], 0
        ))
        img = load_image(image_paths[i], img_wh)[..., :3]
        rgbs_list.append(img.reshape(h, w, 3))
        rays_list.append(llff_rays(directions, c2w, focal, img_wh))

    all_rays, all_rgbs = stack_or_flatten(rays_list, rgbs_list, is_stack)
    K = np.array(
        [[[focal[0], 0, w / 2], [0, focal[1], h / 2], [0, 0, 1]]], np.float32
    )
    return RayDataset(
        all_rays=all_rays, all_rgbs=all_rgbs, poses=np.stack(used_poses),
        K=K, scene_bbox=SCENE_BBOX.copy(), near_far=(0.0, 1.0),
        white_bg=False, img_wh=img_wh, is_stack=is_stack, split=split,
        downsample=downsample, directions=np.asarray(directions, np.float32),
        render_path=render_path,
    )
