"""COLMAP pose normalization helpers for the mip360/co3d-style loaders
(reference dataLoader/utils.py:16-193)."""

from __future__ import annotations

import numpy as np


def normalize(x):
    return x / np.linalg.norm(x)


def viewmatrix(lookdir, up, position, subtract_position: bool = False):
    """(reference dataLoader/utils.py:20-26)"""
    vec2 = normalize((lookdir - position) if subtract_position else lookdir)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, position], axis=1)


def poses_avg(poses):
    """(reference dataLoader/utils.py:28-35)"""
    position = np.mean(poses[:, :3, 3], axis=0)
    z_axis = np.mean(poses[:, :3, 2], axis=0)
    up = np.mean(poses[:, :3, 1], axis=0)
    cam2world = viewmatrix(z_axis, up, position)
    return np.concatenate(
        [cam2world, np.array([[0.0, 0.0, 0.0, 1.0]], poses.dtype)], axis=-2
    )


def fit_3d_plane(pts):
    """LSQ plane fit -> (offset, unit normal)
    (reference dataLoader/utils.py:106-116)."""
    g = np.ones((pts.shape[0], 3))
    g[:, 0] = pts[:, 0]
    g[:, 1] = pts[:, 1]
    (a, b, c), *_ = np.linalg.lstsq(g, pts[:, 2], rcond=None)
    n = np.array([a, b, -1.0])
    return c, n / np.linalg.norm(n)


def rotation_matrix_from_vectors(vec1, vec2):
    """Rodrigues rotation aligning vec1 to vec2
    (reference dataLoader/utils.py:91-103)."""
    a = vec1 / np.linalg.norm(vec1)
    b = vec2 / np.linalg.norm(vec2)
    v = np.cross(a, b)
    c = float(a @ b)
    s = np.linalg.norm(v)
    if s < 1e-12:
        return np.eye(3) if c > 0 else -np.eye(3)
    kmat = np.array(
        [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]]
    )
    return np.eye(3) + kmat + kmat @ kmat * ((1 - c) / (s ** 2))


def intersect_lines_lsq(points, dirs):
    """Least-squares intersection of lines (numpy twin of
    pose.geometry.compute_line_intersection_impl2; replaces the reference's
    pytorch3d-based intersect_skew_lines_high_dim)."""
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    eye = np.eye(3)
    projs = eye[None] - dirs[:, :, None] * dirs[:, None, :]
    r_mat = projs.sum(0)
    q = (projs @ points[:, :, None]).sum(0)
    return np.linalg.solve(r_mat, q)[:, 0]


def compute_optical_axis_intersection(cam2world):
    """(reference dataLoader/utils.py:69-88)"""
    dirs = cam2world[:, :3, :3] @ np.array([0.0, 0.0, 1.0])
    oris = cam2world[:, :3, -1]
    return intersect_lines_lsq(oris, dirs)


def recenter_poses(cam2world, pose_avg=None, method: str = "fitting"):
    """Recenter poses; returns (poses_recentered, inverse_transform)
    (reference dataLoader/utils.py:119-162)."""
    if pose_avg is not None:
        cam2world_avg = np.linalg.inv(pose_avg)
    elif method == "pca":
        t = cam2world[:, :3, 3]
        t_mean = t.mean(axis=0)
        t = t - t_mean
        eigval, eigvec = np.linalg.eig(t.T @ t)
        inds = np.argsort(eigval)[::-1]
        rot = eigvec[:, inds].T
        if np.linalg.det(rot) < 0:
            rot = np.diag([1, 1, -1]) @ rot
        transform = np.concatenate([rot, rot @ -t_mean[:, None]], -1)
        poses_recentered = transform @ cam2world
        transform = np.concatenate([transform, np.eye(4)[3:]], axis=0)
        if poses_recentered.mean(axis=0)[2, 1] < 0:
            transform = np.diag([1, -1, -1, 1]) @ transform
        cam2world_avg = transform
    else:  # 'fitting': align the camera plane's normal to +z, origin at the
        # optical-axis intersection
        rotation = np.eye(4, dtype=cam2world.dtype)
        _, plane_normal = fit_3d_plane(cam2world[:, :3, -1])
        rotation[:3, :3] = rotation_matrix_from_vectors(
            plane_normal, np.array([0.0, 0.0, 1.0])
        )
        translation = np.eye(4, dtype=cam2world.dtype)
        p_intersect = compute_optical_axis_intersection(
            rotation[None] @ cam2world
        )
        translation[:3, -1] = -p_intersect
        cam2world_avg = translation @ rotation

    recentered = cam2world_avg @ cam2world
    return recentered, np.linalg.inv(cam2world_avg)


def rescale_poses(poses, scale=None):
    """(reference dataLoader/utils.py:175-182)"""
    s = scale if scale is not None else np.max(
        np.linalg.norm(poses[:, :3, -1], axis=-1)
    )
    poses = poses.copy()
    poses[:, :3, -1] /= s
    return poses, s
