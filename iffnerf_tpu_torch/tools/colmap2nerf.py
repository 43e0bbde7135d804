"""COLMAP sparse model -> transforms.json converter of the port, over its
own COLMAP readers (``data/colmap.py``): the JAX package's
``tools/colmap2nerf.py`` (reference dataLoader/colmap2nerf.py; its COLMAP
and ffmpeg steps need binaries, the conversion works on any existing
``sparse/0`` model).

    python -m iffnerf_tpu_torch.tools.colmap2nerf \\
        --colmap_dir <scene>/sparse/0 --images images \\
        --out <scene>/transforms_train.json [--aabb_scale 16]
"""

from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np

from iffnerf_tpu_torch.data.colmap import (
    qvec2rotmat,
    read_extrinsics_binary,
    read_extrinsics_text,
    read_intrinsics_binary,
    read_intrinsics_text,
)

OPENCV2BLENDER = np.diag([1.0, -1.0, -1.0, 1.0])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--colmap_dir", required=True,
                    help="path to the sparse/0 model")
    ap.add_argument("--images", default="images",
                    help="image dir name relative to the json")
    ap.add_argument("--out", required=True)
    ap.add_argument("--aabb_scale", type=int, default=16)
    args = ap.parse_args(argv)

    try:
        intr = read_intrinsics_binary(
            os.path.join(args.colmap_dir, "cameras.bin"))
        extr = read_extrinsics_binary(
            os.path.join(args.colmap_dir, "images.bin"))
    except Exception:  # no binary model (or a broken one): the text model
        intr = read_intrinsics_text(
            os.path.join(args.colmap_dir, "cameras.txt"))
        extr = read_extrinsics_text(
            os.path.join(args.colmap_dir, "images.txt"))

    cam = next(iter(intr.values()))
    if cam.model == "SIMPLE_PINHOLE":
        fx = fy = cam.params[0]
        cx, cy = cam.params[1], cam.params[2]
    elif cam.model in ("PINHOLE", "OPENCV", "SIMPLE_RADIAL", "RADIAL"):
        fx = cam.params[0]
        fy = cam.params[1] if cam.model != "SIMPLE_RADIAL" else cam.params[0]
        cx, cy = (cam.params[2], cam.params[3]) if cam.model != \
            "SIMPLE_RADIAL" else (cam.params[1], cam.params[2])
    else:
        raise ValueError(f"camera model {cam.model} not supported")

    frames = []
    for img in sorted(extr.values(), key=lambda i: i.name):
        w2c = np.eye(4)
        w2c[:3, :3] = qvec2rotmat(img.qvec)
        w2c[:3, 3] = img.tvec
        c2w_blender = np.linalg.inv(w2c) @ OPENCV2BLENDER
        name = os.path.splitext(img.name)[0]
        frames.append({
            "file_path": f"./{args.images}/{name}",
            "transform_matrix": c2w_blender.tolist(),
        })

    out = {
        "camera_angle_x": 2.0 * math.atan(cam.width / (2.0 * fx)),
        "camera_angle_y": 2.0 * math.atan(cam.height / (2.0 * fy)),
        "fl_x": fx, "fl_y": fy, "cx": cx, "cy": cy,
        "w": cam.width, "h": cam.height,
        "aabb_scale": args.aabb_scale,
        "frames": frames,
    }
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=2)
    print(f"wrote {args.out} ({len(frames)} frames)")


if __name__ == "__main__":
    main()
