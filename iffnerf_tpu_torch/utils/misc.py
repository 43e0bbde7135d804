"""Grid-resolution helpers (reference utils.py:20-29, train.py:204-215), a
copy of the JAX package's host numpy."""

from __future__ import annotations

import numpy as np


def N_to_reso(n_voxels: int, bbox) -> list[int]:
    """Voxel count -> per-axis resolution (reference utils.py:20-24)."""
    bbox = np.asarray(bbox, dtype=np.float64)
    xyz_min, xyz_max = bbox[0], bbox[1]
    voxel_size = ((xyz_max - xyz_min).prod() / n_voxels) ** (1.0 / 3.0)
    return [int(v) for v in ((xyz_max - xyz_min) / voxel_size)]


def cal_n_samples(reso, step_ratio: float = 0.5) -> int:
    """(reference utils.py:27-28)"""
    return int(np.linalg.norm(np.asarray(reso, dtype=np.float64)) / step_ratio)


def n_voxel_schedule(n_init: int, n_final: int, n_upsamples: int) -> list[int]:
    """Log-linear voxel-count schedule (reference train.py:204-215)."""
    return [
        int(round(float(v)))
        for v in np.exp(
            np.linspace(np.log(n_init), np.log(n_final), n_upsamples + 1)
        )
    ][1:]
