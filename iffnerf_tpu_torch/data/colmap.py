"""COLMAP sparse-model readers (binary + text) — the standard COLMAP format
(reference dataLoader/colmap_utils.py:95-347; format spec:
colmap.github.io/format.html)."""

from __future__ import annotations

import collections
import struct

import numpy as np

Camera = collections.namedtuple(
    "Camera", ["id", "model", "width", "height", "params"]
)
ColmapImage = collections.namedtuple(
    "ColmapImage",
    ["id", "qvec", "tvec", "camera_id", "name", "xys", "point3D_ids"],
)

# (model_id, name, n_params) per the COLMAP camera-model enum
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


def qvec2rotmat(qvec) -> np.ndarray:
    """Quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w,
         2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
         1 - 2 * x * x - 2 * y * y],
    ])


def _read(fid, n_bytes, fmt):
    return struct.unpack("<" + fmt, fid.read(n_bytes))


def read_intrinsics_binary(path: str) -> dict:
    cameras = {}
    with open(path, "rb") as fid:
        (n,) = _read(fid, 8, "Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(fid, 24, "iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(fid, 8 * n_params, "d" * n_params))
            cameras[cam_id] = Camera(cam_id, name, width, height, params)
    return cameras


def read_extrinsics_binary(path: str) -> dict:
    images = {}
    with open(path, "rb") as fid:
        (n,) = _read(fid, 8, "Q")
        for _ in range(n):
            vals = _read(fid, 64, "idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            char = fid.read(1)
            while char != b"\x00":
                name += char
                char = fid.read(1)
            (n_pts,) = _read(fid, 8, "Q")
            data = _read(fid, 24 * n_pts, "ddq" * n_pts)
            xys = np.column_stack(
                [np.array(data[0::3]), np.array(data[1::3])]
            )
            point3d_ids = np.array(data[2::3], dtype=np.int64)
            images[image_id] = ColmapImage(
                image_id, qvec, tvec, camera_id, name.decode("utf-8"), xys,
                point3d_ids,
            )
    return images


def read_points3D_binary(path: str):
    with open(path, "rb") as fid:
        (n,) = _read(fid, 8, "Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3), dtype=np.uint8)
        err = np.empty(n)
        for i in range(n):
            vals = _read(fid, 43, "QdddBBBd")
            xyz[i] = vals[1:4]
            rgb[i] = vals[4:7]
            err[i] = vals[7]
            (track_len,) = _read(fid, 8, "Q")
            fid.seek(8 * track_len, 1)
    return xyz, rgb, err


def read_intrinsics_text(path: str) -> dict:
    cameras = {}
    with open(path) as fid:
        for line in fid:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            cameras[int(elems[0])] = Camera(
                int(elems[0]), elems[1], int(elems[2]), int(elems[3]),
                np.array([float(x) for x in elems[4:]]),
            )
    return cameras


def read_extrinsics_text(path: str) -> dict:
    images = {}
    with open(path) as fid:
        # keep blank lines: entries are (header, points2D) PAIRS and the
        # points line is legitimately empty for images without 2D points —
        # dropping blanks would misalign every following pair
        lines = [
            ln.strip() for ln in fid if not ln.strip().startswith("#")
        ]
        while lines and not lines[-1]:
            lines.pop()
    for i in range(0, len(lines), 2):
        elems = lines[i].split()
        image_id = int(elems[0])
        qvec = np.array([float(x) for x in elems[1:5]])
        tvec = np.array([float(x) for x in elems[5:8]])
        camera_id = int(elems[8])
        name = elems[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array(
            [[float(pts[j]), float(pts[j + 1])] for j in range(0, len(pts), 3)]
        ) if pts else np.zeros((0, 2))
        point3d_ids = np.array(
            [int(pts[j + 2]) for j in range(0, len(pts), 3)], dtype=np.int64
        ) if pts else np.zeros(0, dtype=np.int64)
        images[image_id] = ColmapImage(
            image_id, qvec, tvec, camera_id, name, xys, point3d_ids
        )
    return images


def read_points3D_text(path: str):
    xyz, rgb, err = [], [], []
    with open(path) as fid:
        for line in fid:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            xyz.append([float(x) for x in elems[1:4]])
            rgb.append([int(x) for x in elems[4:7]])
            err.append(float(elems[7]))
    return np.array(xyz), np.array(rgb, dtype=np.uint8), np.array(err)
