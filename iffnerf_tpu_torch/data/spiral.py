"""Spiral camera paths (reference dataLoader/spiral_utils.py:6-80)."""

from __future__ import annotations

import numpy as np


def create_spiral_points(num_loops: int = 3, num_points: int = 100):
    """Unit-cube spiral descending in z (reference :6-33)."""
    z = np.linspace(0.0, 1.0, num_points)
    theta = np.linspace(0, num_loops * 2 * np.pi, num_points)
    r = 2.0 + 0.2 ** z * theta
    x = r * np.cos(theta)
    y = r * np.sin(theta)
    z = 1.0 - z
    scaling = max(x.max(), y.max())
    x = (x / scaling + 1.0) / 2.0
    y = (y / scaling + 1.0) / 2.0
    return np.stack([x, y, z], axis=-1)


def make_look_at(position, target, up) -> np.ndarray:
    """Opencv-style look-at c2w with column layout [right, up, forward, pos]
    (reference :39-64)."""
    forward = target - position
    forward = forward / np.linalg.norm(forward)
    right = np.cross(forward, up)
    if np.linalg.norm(right) < 1e-3:
        right = np.cross(forward, up + np.array([1e-3, 0.0, 0.0]))
    right = right / np.linalg.norm(right)
    up2 = np.cross(right, forward)
    up2 = up2 / np.linalg.norm(up2)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up2, forward, \
        position
    return c2w


def create_spiral(scene_aabb, up, invert_z: bool = False) -> np.ndarray:
    """Spiral path scaled to the scene AABB, looking at its center
    (reference :67-80). Returns [N, 4, 4]."""
    scene_aabb = np.asarray(scene_aabb, dtype=np.float64)
    center = (scene_aabb[0] + scene_aabb[1]) / 2.0
    pts = create_spiral_points()
    if invert_z:
        pts = pts.copy()
        pts[..., -1] = 1.0 - pts[..., -1]
    positions = pts * (scene_aabb[1] - scene_aabb[0]) + scene_aabb[0]
    return np.stack(
        [make_look_at(p, center, np.asarray(up, np.float64))
         for p in positions]
    ).astype(np.float32)
