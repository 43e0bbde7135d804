"""A synthetic Blender-format scene volume-rendered on the card: the JAX
package's ``extra/gen_fixture_scene.py`` in torch.

The analytic scenes of the test fixtures (``tests/fixtures.py``: the
same constants and cameras, kept here), rendered by a march of
``--n_steps`` samples a ray on the CUDA card unless ``--device cpu``, so
that a 116-view 800x800 scene takes seconds where the numpy generator
takes an hour. Run from the repository's root:

    python -m iffnerf_tpu_torch.tools.gen_fixture_scene --root DIR \\
        --shape cluster --wh 800 --n_train 100 --n_test 8
"""

from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np
import torch

from iffnerf_tpu_torch.device import resolve_device


# lego's field of view and the "cluster" scene (a central ball and six
# axis satellites: centre, radius), as the test fixtures define them
CAMERA_ANGLE_X = 0.6911112070083618
CLUSTER = (((0.0, 0.0, 0.0), 0.22),
           ((0.47, 0.0, 0.0), 0.125), ((-0.47, 0.0, 0.0), 0.125),
           ((0.0, 0.47, 0.0), 0.125), ((0.0, -0.47, 0.0), 0.125),
           ((0.0, 0.0, 0.47), 0.125), ((0.0, 0.0, -0.47), 0.125))


def lookat_blender(campos, target=np.zeros(3), up=np.array([0.0, 0.0, 1.0])):
    """The Blender camera-to-world matrix [4, 4] at ``campos`` looking at
    ``target``."""
    z = campos - target
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, campos
    return c2w


def _sigma_ball(x):
    r = torch.linalg.norm(x, dim=-1)
    return 30.0 / (1.0 + torch.exp(-20.0 * (0.7 - r)))


def _sigma_cluster(x):
    s = torch.full(x.shape[:-1], math.inf, device=x.device)
    for c, r in CLUSTER:
        s = torch.minimum(s, torch.linalg.norm(
            x - torch.as_tensor(c, dtype=x.dtype, device=x.device),
            dim=-1) - r)
    return 30.0 / (1.0 + torch.exp(160.0 * s))


SIGMAS = {"ball": _sigma_ball, "cluster": _sigma_cluster}


def render_view(c2w_blender, wh: int, n_steps: int, shape: str,
                device) -> np.ndarray:
    """One view of the scene from the Blender camera ``c2w_blender``:
    uint8 RGBA [wh, wh, 4], the colour over the march and its opacity
    (the JAX script's ``_render_view_j``)."""
    w = h = wh
    focal = 0.5 * w / np.tan(0.5 * CAMERA_ANGLE_X)
    i, j = torch.meshgrid(
        torch.arange(w, dtype=torch.float32, device=device) + 0.5,
        torch.arange(h, dtype=torch.float32, device=device) + 0.5,
        indexing="xy")
    dirs_cam = torch.stack([(i - w / 2) / focal, (j - h / 2) / focal,
                            torch.ones_like(i)], -1)
    b2o = torch.diag(torch.tensor([1.0, -1.0, -1.0, 1.0], device=device))
    c2w = torch.as_tensor(c2w_blender, dtype=torch.float32,
                          device=device) @ b2o
    dirs = dirs_cam @ c2w[:3, :3].T
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    origin = c2w[:3, 3]
    ts = torch.linspace(2.0, 6.0, n_steps, device=device)
    dt = ts[1] - ts[0]
    sigma_fn = SIGMAS[shape]
    rgb = torch.zeros((h, w, 3), device=device)
    trans = torch.ones((h, w), device=device)
    for t in ts:
        pts = origin + dirs * t
        alpha = 1.0 - torch.exp(-sigma_fn(pts) * dt)
        weight = trans * alpha
        color = 0.5 + 0.45 * torch.cos(torch.pi * pts * 2.0)
        rgb = rgb + weight[..., None] * color
        trans = trans * (1.0 - alpha)
    rgba = torch.cat([torch.clip(rgb, 0, 1), (1.0 - trans)[..., None]], -1)
    return (rgba * 255).to(torch.uint8).cpu().numpy()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--shape", choices=list(SIGMAS), default="cluster")
    ap.add_argument("--wh", type=int, default=800)
    ap.add_argument("--n_train", type=int, default=100)
    ap.add_argument("--n_test", type=int, default=8)
    ap.add_argument("--n_steps", type=int, default=192)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from PIL import Image

    rng = np.random.default_rng(args.seed)
    for split, n in (("train", args.n_train), ("test", args.n_test),
                     ("val", args.n_test)):
        frames = []
        os.makedirs(os.path.join(args.root, split), exist_ok=True)
        for k in range(n):
            theta = 2 * np.pi * (k + (0.33 if split != "train" else 0)) / n
            phi = np.deg2rad(30 + 25 * rng.random())
            campos = 4.0 * np.array(
                [np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi),
                 np.sin(phi)])
            c2w = lookat_blender(campos)
            img = render_view(c2w, args.wh, args.n_steps, args.shape, dev)
            rel = f"./{split}/r_{k}"
            Image.fromarray(img, "RGBA").save(
                os.path.join(args.root, f"{rel[2:]}.png"))
            frames.append({"file_path": rel,
                           "transform_matrix": c2w.tolist()})
            print(f"{split} {k + 1}/{n}", flush=True)
        with open(os.path.join(args.root, f"transforms_{split}.json"),
                  "w") as f:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X,
                       "frames": frames}, f)
    print("done", args.root)


if __name__ == "__main__":
    main()
