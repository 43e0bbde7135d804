"""CO3D loader (reference dataLoader/co3d.py:35-454).

Parses ``frame_annotations.jgz`` (gzipped JSON) and ``set_lists/*.json``
directly with the standard library — no pytorch3d dataclasses. Camera
conversion parity: the PyTorch3D NDC viewpoint (R, T, focal, principal
point) is converted to an opencv c2w + pixel-space K exactly as the
reference (co3d.py:133-177: XY flip, rotation transpose, NDC->pixel via
min(image size)/2), poses recentered + rescaled; masks loaded from the
annotation's mask path; bbox ±1, near/far [0.1, 0.8], white bg.

``datadir`` points at ``<co3d_root>/<category>/<sequence>``, as the
reference's training script passes it. The geometry
(``read_category_annotations``, ``co3d_rays``) is apart from the image
reads, so that a sequence's rays can be made from its annotation files
alone.
"""

from __future__ import annotations

import gzip
import json
import os

import numpy as np

from iffnerf_tpu_torch.data.base import RayDataset, load_image, stack_or_flatten
from iffnerf_tpu_torch.data.pose_utils import recenter_poses, rescale_poses
from iffnerf_tpu_torch.data.rays_np import ray_directions_Ks_np, rays_with_radii_np

CO3D2OPENCV = np.diag([-1.0, -1.0, 1.0, 1.0]).astype(np.float32)
SCENE_BBOX = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
NEAR_FAR = (0.1, 0.8)


def _read_set_lists(category_dir: str, sequence_name: str):
    """(reference co3d.py:112-129)"""
    sets = {"train": set(), "val": set(), "test": set()}
    set_dir = os.path.join(category_dir, "set_lists")
    if not os.path.isdir(set_dir):
        return sets
    for fname in os.listdir(set_dir):
        path = os.path.join(set_dir, fname)
        if not os.path.isfile(path):
            continue
        with open(path) as fh:
            data = json.load(fh)
        for split in sets:
            for entry in data.get(split, []):
                if entry[0] == sequence_name:
                    sets[split].add(entry[1])
    return sets


def read_category_annotations(category_dir: str, sequence_name: str):
    """frame_annotations.jgz -> per-split frame dicts with converted
    opencv c2w + pixel K (reference co3d.py:99-220)."""
    with gzip.open(
        os.path.join(category_dir, "frame_annotations.jgz"), "rt"
    ) as fh:
        annotations = json.load(fh)

    sets = _read_set_lists(category_dir, sequence_name)

    frames, cam2worlds, intrinsics = [], [], []
    for ann in annotations:
        if ann["sequence_name"] != sequence_name:
            continue
        vp = ann["viewpoint"]
        mtx = np.eye(4, dtype=np.float32)
        mtx[:3, :3] = np.asarray(vp["R"], np.float32)
        mtx[:3, -1] = np.asarray(vp["T"], np.float32)
        mtx = mtx @ CO3D2OPENCV
        mtx[:3, :3] = mtx[:3, :3].T

        img_h, img_w = ann["image"]["size"]
        scale = min(img_h, img_w) / 2.0
        cx = -vp["principal_point"][0] * scale + img_w / 2.0
        cy = -vp["principal_point"][1] * scale + img_h / 2.0
        fx = -vp["focal_length"][0] * scale
        fy = -vp["focal_length"][1] * scale

        frames.append(ann)
        cam2worlds.append(np.linalg.inv(mtx))
        intrinsics.append(
            np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        )

    cam2worlds = np.stack(cam2worlds)
    cam2worlds, inv_transformation = recenter_poses(cam2worlds)
    cam2worlds, inv_scale = rescale_poses(cam2worlds)

    split_frames = {"train": [], "val": [], "test": []}
    for ann, c2w, K in zip(frames, cam2worlds, intrinsics):
        for split, members in sets.items():
            if ann["frame_number"] in members:
                split_frames[split].append((ann, c2w, K))
    return split_frames, inv_scale, inv_transformation


def co3d_rays(K: np.ndarray, c2w: np.ndarray, img_wh,
              downsample: float = 1.0) -> np.ndarray:
    """An image's rays with mip radii [h, w, 7] float32 from its annotation's
    pixel K [3, 3] and c2w [4, 4] at the image size img_wh after
    ``downsample``: K's y axis flipped (CO3D's intrinsics mirror opencv's
    pixels) and scaled by 1 / downsample."""
    w, h = img_wh
    flip = np.diag([1.0, -1.0, 1.0]).astype(np.float32)
    K_scaled = (flip @ K).astype(np.float32) / downsample
    K_scaled[2, 2] = 1.0
    ori_dirs, dx, dy = ray_directions_Ks_np(h, w, K_scaled[None])
    ori_dirs, dx, dy = ori_dirs[0], dx[0], dy[0]
    dirs = ori_dirs / np.linalg.norm(ori_dirs, axis=-1, keepdims=True)
    rays_o, rays_d, radii = rays_with_radii_np(
        dirs, c2w.astype(np.float32), directions=ori_dirs, dx=dx, dy=dy,
        keepdim=True,
    )
    return np.concatenate([rays_o, rays_d, radii], -1).astype(np.float32)


def load_co3d(datadir: str, split: str = "train", downsample: float = 1.0,
              is_stack: bool = False, **kwargs) -> RayDataset:
    sequence_name = os.path.basename(os.path.normpath(datadir))
    category_dir = os.path.dirname(os.path.normpath(datadir))
    co3d_root = os.path.dirname(category_dir)

    split_frames, _, _ = read_category_annotations(category_dir,
                                                   sequence_name)
    frames = split_frames["test" if split in ("test", "val") else "train"]
    if not frames:
        raise FileNotFoundError(
            f"no frames for sequence {sequence_name} split {split}"
        )

    poses, rays_list, rgbs_list = [], [], []
    img_wh = None
    for ann, c2w, K in frames:
        img_path = ann["image"]["path"]
        if not os.path.isabs(img_path):
            img_path = os.path.join(co3d_root, img_path)
        img = load_image(img_path)
        h, w = img.shape[:2]
        if downsample != 1.0:
            img = load_image(
                img_path, (int(w / downsample), int(h / downsample))
            )
            h, w = img.shape[:2]
        img_wh = (w, h)

        mask = np.ones((h, w, 1), np.float32)
        if ann.get("mask") and ann["mask"].get("path"):
            mask_path = ann["mask"]["path"]
            if not os.path.isabs(mask_path):
                mask_path = os.path.join(co3d_root, mask_path)
            if os.path.exists(mask_path):
                mask = load_image(mask_path, (w, h))[..., :1]
        rgbs_list.append(
            np.concatenate([img[..., :3], mask], axis=-1)
        )
        poses.append(c2w.astype(np.float32))
        rays_list.append(co3d_rays(K, c2w, img_wh, downsample))

    all_rays, all_rgbs = stack_or_flatten(rays_list, rgbs_list, is_stack)
    return RayDataset(
        all_rays=all_rays, all_rgbs=all_rgbs, poses=np.stack(poses),
        K=np.asarray(frames[0][2])[None].astype(np.float32),
        scene_bbox=SCENE_BBOX.copy(),
        near_far=NEAR_FAR, white_bg=True, img_wh=img_wh,
        is_stack=is_stack, split=split, downsample=downsample,
    )
