"""CO3D-Metashape loader (reference dataLoader/co3d_metashape.py:1-325).

Combines the two formats the reference marries:

  * split membership from CO3D machinery — ``frame_annotations.jgz`` in the
    category dir filtered by ``set_lists/*.json`` (co3d_metashape.py:36-106);
    only the frames' image BASENAMES are used,
  * cameras from Metashape ``cameras.xml`` inside the sequence dir
    (``img_dirname='images'``, co3d_metashape.py:111-113), with the
    undistorted renders (``undistorted_images/``) as pixels and
    ``masks_metashape/`` masks thresholded at 0.3 then ceiled
    (co3d_metashape.py:141-152).

Contract parity: 6-channel rays (origin + normalized viewdirs from integer
pixel coords, co3d_metashape.py:229-269), flat [H*W, 6] an image, so a
stacked set is [N, H*W, 6] as the JAX package's; bbox +-1, near/far
[0.1, 1.5], white bg, spiral render path from the mean camera up
(co3d_metashape.py:202-221). The reference's n_test_interpolation pose
blending defaults to 0 and is unused by the reference's scripts — not
replicated.

The geometry (``_split_image_basenames``, ``load_cameras_xml``,
``co3d_metashape_rays``) is apart from the image reads.
"""

from __future__ import annotations

import gzip
import json
import os

import numpy as np

from iffnerf_tpu_torch.data.base import RayDataset, load_image, stack_or_flatten
from iffnerf_tpu_torch.data.co3d import _read_set_lists
from iffnerf_tpu_torch.data.metashape import load_cameras_xml
from iffnerf_tpu_torch.data.rays_np import ray_directions_Ks_np
from iffnerf_tpu_torch.data.repair import homogeneous, spiral_path

SCENE_BBOX = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
NEAR_FAR = (0.1, 1.5)


def _split_image_basenames(category_dir: str, sequence_name: str,
                           split: str):
    """Image basenames of the sequence's frames in the given split, in
    frame-annotation order (reference co3d_metashape.py:36-106; poses are
    NOT taken from the CO3D viewpoints here, so only names are needed)."""
    with gzip.open(
        os.path.join(category_dir, "frame_annotations.jgz"), "rt"
    ) as fh:
        annotations = json.load(fh)
    members = _read_set_lists(category_dir, sequence_name)[split]
    return [
        os.path.basename(ann["image"]["path"])
        for ann in annotations
        if ann["sequence_name"] == sequence_name
        and ann["frame_number"] in members
    ]


def co3d_metashape_rays(K: np.ndarray, c2w: np.ndarray, img_wh) -> np.ndarray:
    """An image's rays [h * w, 6] float32 from its camera's K [3, 3] and c2w
    [4, 4]: integer pixel coordinates (no pixel centres, reference
    meshgrid, :229) and normalised view directions (:263-273)."""
    w, h = img_wh
    dirs, _, _ = ray_directions_Ks_np(h, w, K[None], use_pixel_centers=False)
    dirs = dirs[0]
    rays_d = dirs @ c2w[:3, :3].T
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
    return np.concatenate([rays_o, rays_d], -1).reshape(-1, 6).astype(
        np.float32)


def load_co3d_metashape(datadir: str, split: str = "train",
                        downsample: float = 1.0, is_stack: bool = False,
                        **kwargs) -> RayDataset:
    if split not in ("train", "test"):  # reference SPLITS, :195
        raise ValueError(f"co3d_metashape split must be train/test: {split}")
    sequence_name = os.path.basename(os.path.normpath(datadir))
    category_dir = os.path.dirname(os.path.normpath(datadir))

    names = _split_image_basenames(category_dir, sequence_name, split)
    if not names:
        raise FileNotFoundError(
            f"no frames for sequence {sequence_name} split {split}"
        )

    cameras, _, _ = load_cameras_xml(
        os.path.join(datadir, "cameras.xml"), datadir,
        img_resize_factor=downsample, img_dirname="images",
    )
    if not cameras:
        raise FileNotFoundError(f"no usable cameras.xml under {datadir}")
    by_name = {
        os.path.basename(f): i for i, f in enumerate(cameras["filenames"])
    }

    poses, Ks, rays_list, rgbs_list = [], [], [], []
    img_wh = None
    for name in names:
        if name not in by_name:  # reference asserts (:137)
            raise KeyError(f"annotated image {name} not in cameras.xml")
        i = by_name[name]

        path = cameras["metashape_filenames"][i]
        if downsample != 1.0:
            from PIL import Image

            # .size reads the header only — no full-res decode
            w0, h0 = Image.open(path).size
            img = load_image(path, (int(w0 / downsample),
                                    int(h0 / downsample)))
        else:
            img = load_image(path)
        h, w = img.shape[:2]
        img_wh = (w, h)

        mask_path = cameras["metashape_masks"][i]
        if os.path.exists(mask_path):
            m = load_image(mask_path, (w, h))
            # reference order (co3d_metashape.py:146-152): threshold 0.3
            # and ceil PER CHANNEL, then average — channels that disagree
            # yield fractional alpha, which averaging-first would lose
            m = np.ceil(np.where(m < 0.3, 0.0, m))
            if m.shape[-1] > 1:
                m = np.mean(m, axis=-1, keepdims=True)
            mask = m.astype(np.float32)
        else:
            mask = np.ones((h, w, 1), np.float32)
        rgbs_list.append(np.concatenate([img[..., :3], mask], axis=-1))

        c2w = homogeneous(cameras["cam2world"][i])
        poses.append(c2w)
        K = cameras["Ks"][i].astype(np.float32)
        Ks.append(K)
        rays_list.append(co3d_metashape_rays(K, c2w, img_wh))

    all_rays, all_rgbs = stack_or_flatten(rays_list, rgbs_list, is_stack)
    poses_np = np.stack(poses)
    return RayDataset(
        all_rays=all_rays, all_rgbs=all_rgbs, poses=poses_np,
        K=Ks[0][None],
        scene_bbox=SCENE_BBOX.copy(), near_far=NEAR_FAR, white_bg=True,
        img_wh=img_wh, is_stack=is_stack, split=split, downsample=downsample,
        render_path=spiral_path(SCENE_BBOX, poses_np),
    )
