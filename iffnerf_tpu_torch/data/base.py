"""Common dataset container + shared numpy helpers for loaders."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RayDataset:
    """The duck-typed dataset contract of the reference loaders
    (e.g. dataLoader/blender.py:105-133)."""

    all_rays: np.ndarray          # [sum HW, 6|7] flat or [N, H, W, 6|7] stacked
    all_rgbs: np.ndarray          # [sum HW, C] or [N, H, W, C], C in {3, 4}
    poses: np.ndarray             # [N, 4, 4] c2w (opencv convention)
    K: np.ndarray                 # [1, 3, 3] intrinsics
    scene_bbox: np.ndarray        # [2, 3]
    near_far: tuple
    white_bg: bool
    img_wh: tuple                 # (W, H)
    is_stack: bool
    split: str
    downsample: float = 1.0
    directions: np.ndarray | None = None  # [H, W, 3] camera-frame dirs
    render_path: np.ndarray | None = None  # [M, 4, 4] eval camera path
    all_masks: np.ndarray | None = None

    def __len__(self):
        return len(self.all_rgbs)

    def __getitem__(self, idx):
        """Reference-style sample dict (dataLoader/blender.py:148-158)."""
        return {"rays": self.all_rays[idx], "rgbs": self.all_rgbs[idx]}


BLENDER2OPENCV = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]],
    dtype=np.float64,
)


def load_image(path: str, img_wh=None) -> np.ndarray:
    """PNG/JPG -> float32 [H, W, C] in [0, 1]; optional LANCZOS resize
    (torchvision ToTensor + PIL resize, dataLoader/blender.py:96-101)."""
    from PIL import Image

    img = Image.open(path)
    if img_wh is not None and tuple(img.size) != tuple(img_wh):
        img = img.resize(tuple(img_wh), Image.LANCZOS)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def stack_or_flatten(rays_list, rgbs_list, is_stack: bool):
    """The reference stacking convention (dataLoader/blender.py:118-133):
    flat [sum HW, C] for training, stacked [N, H, W, C] for eval."""
    if not is_stack:
        rays = np.concatenate(
            [r.reshape(-1, r.shape[-1]) for r in rays_list], axis=0)
        rgbs = np.concatenate(
            [r.reshape(-1, r.shape[-1]) for r in rgbs_list], axis=0)
    else:
        rays = np.stack(rays_list, axis=0)
        rgbs = np.stack(rgbs_list, axis=0)
    return rays.astype(np.float32), rgbs.astype(np.float32)
