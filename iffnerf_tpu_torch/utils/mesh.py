"""Mesh export from the dense alpha field (reference utils.py:168-228,
train.py:39-49: marching cubes over dense alpha -> PLY), the JAX package's
``utils/mesh.py``.

The dense alpha comes from ``get_dense_alpha`` on the field's device (on
the card, the density-only ``field_features`` kernel over the lattice);
the triangulation runs on the host, in the C++ of
``csrc/marching_cubes.cpp``, as in the JAX package. That source is built
with g++ at first use into ``build/host`` at the root of the checkout
(listed in ``.gitignore``; the file name carries a hash of the source and
flags) and loaded with ctypes. There is no fallback: a failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from iffnerf_tpu_torch.models.field import get_dense_alpha

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "marching_cubes.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LIB = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"marching_cubes-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compiles ``csrc/marching_cubes.cpp`` with g++ unless its library is
    there -> the library's path. Raises with g++'s output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE} (rc {proc.returncode}):"
                           f"\n{proc.stdout}{proc.stderr}"[-4000:])
    os.replace(tmp, out)
    return out


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.mc_run.restype = ctypes.c_void_p
        lib.mc_run.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.mc_copy.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.mc_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Minimal binary-little-endian PLY writer (replaces plyfile). An
    empty mesh writes the header alone (the JAX package's writer raises
    on it)."""
    verts = np.asarray(verts, dtype=np.float32)
    faces = np.asarray(faces, dtype=np.int32)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(verts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(verts.astype("<f4").tobytes())
        counts = np.full((len(faces), 1), 3, dtype=np.uint8)
        body = np.concatenate(
            [counts.view(np.uint8),
             faces.astype("<i4").view(np.uint8).reshape(len(faces), 12)],
            axis=1,
        )
        f.write(body.tobytes())


def read_ply(path) -> tuple[np.ndarray, np.ndarray]:
    """(verts [V, 3] float32, faces [F, 3] int32) of a PLY as ``write_ply``
    lays it out; raises on another layout."""
    raw = Path(path).read_bytes()
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:end].decode("ascii").split("\n")
    counts = {line.split()[1]: int(line.split()[2]) for line in header
              if line.startswith("element ")}
    nv, nf = counts["vertex"], counts["face"]
    verts = np.frombuffer(raw[end:end + 12 * nv], "<f4").reshape(nv, 3)
    body = np.frombuffer(raw[end + 12 * nv:], np.uint8).reshape(nf, 13)
    if not (body[:, 0] == 3).all():
        raise ValueError(f"{path}: a face without 3 vertices")
    return verts.copy(), body[:, 1:].copy().view("<i4").reshape(nf, 3)


def marching_cubes(volume: np.ndarray, level: float):
    """Triangulate the ``level`` isosurface of ``volume`` [X, Y, Z] on the
    host -> (verts [V, 3] float32 in index coords, faces [F, 3] int32)."""
    vol = np.ascontiguousarray(volume, dtype=np.float32)
    nx, ny, nz = vol.shape
    lib = _lib()
    nv = ctypes.c_int(0)
    nf = ctypes.c_int(0)
    handle = lib.mc_run(
        vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nx, ny, nz, ctypes.c_float(level),
        ctypes.byref(nv), ctypes.byref(nf),
    )
    try:
        verts = np.empty((nv.value, 3), np.float32)
        faces = np.empty((nf.value, 3), np.int32)
        if nv.value:
            lib.mc_copy(
                handle,
                verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
    finally:
        lib.mc_free(handle)
    return verts, faces


def export_mesh_from_field(config, params, mask, path: str,
                           level: float = 0.005, grid_size=None,
                           log: dict | None = None) -> None:
    """Dense alpha -> marching cubes -> PLY in world coordinates
    (reference train.py:39-49 + utils.convert_sdf_samples_to_ply), at the
    field's grid unless ``grid_size`` says otherwise. ``log``, a dict,
    receives the seconds of the dense alpha (up to a synchronize) and of
    the triangulation, and the vertex and face counts."""
    t0 = time.perf_counter()
    with torch.no_grad():
        alpha, _ = get_dense_alpha(config, params, mask, grid_size)
    alpha = alpha.cpu().numpy()
    t1 = time.perf_counter()
    verts, faces = marching_cubes(alpha, level)
    t2 = time.perf_counter()
    aabb = config.aabb_np
    scale = (aabb[1] - aabb[0]) / (np.asarray(alpha.shape) - 1.0)
    verts_world = verts * scale + aabb[0]
    write_ply(path, verts_world, faces)
    if log is not None:
        log.update(alpha_s=t1 - t0, marching_cubes_s=t2 - t1,
                   n_verts=len(verts), n_faces=len(faces),
                   grid=list(alpha.shape))
