"""One rank of the gloo group that tests/test_torch_parallel.py starts: it
runs the port's sharded routes on the inputs in its working directory and
writes what each returns to ``rank<r>.npz`` there.

    python tests/torch_sharded_worker.py <workdir> <rank> <world size>

It imports torch, numpy and the port only (the test process holds JAX and
the package's 8 virtual devices; a child that imported them would start
both again), meets the other ranks through a ``file://`` rendezvous in the
working directory and runs torch on one thread. Keys of the output:
``shard/...`` this rank's rows, ``rep/...`` what every rank returns
alike, ``one/...`` and ``plain/...`` a one-rank group's result and the
same call without a mesh, ``log/...`` what the rank logged.
"""

import dataclasses
import os
import sys
import types

import numpy as np
import torch
import torch.distributed as dist

from iffnerf_tpu_torch.checkpoint import (
    _flatten,
    _numpy_leaves,
    load_field,
    load_pytree,
)
from iffnerf_tpu_torch.device import trainable
from iffnerf_tpu_torch.parallel import make_mesh, pad_to_multiple, shard_rays
from iffnerf_tpu_torch.parallel.mesh import shard_bounds
from iffnerf_tpu_torch.pose.id_module import (
    IDConfig,
    image_queries,
    ray_bank,
    score_rays,
)
from iffnerf_tpu_torch.pose.solve import (
    estimate_pose_single,
    estimate_pose_single_banked,
    estimate_pose_single_sharded,
)
from iffnerf_tpu_torch.pose.test import test_pose_estimation
from iffnerf_tpu_torch.pose.vit import ViTConfig
from iffnerf_tpu_torch.render.renderer import render_chunked
from iffnerf_tpu_torch.train import trainer

# tests/test_parallel.py's shapes: the ID module (ViT dim 32, depth 1),
# 1 600 candidate rays, k = 32; 1 000 rays rendered in chunks of 512 at 16
# samples; two train steps of TRAIN_BATCH rays (UNEVEN_BATCH: a count that
# 4 ranks do not divide)
ID_CONFIG = IDConfig(backbone=ViTConfig(img_size=28, patch_size=14, dim=32,
                                        depth=1, num_heads=4),
                     resize_size=32, crop_size=28)
K, RENDER_CHUNK, RENDER_SAMPLES = 32, 512, 16
TRAIN_BATCH, UNEVEN_BATCH, TRAIN_SAMPLES = 256, 254, 60
LR_SPATIAL, LR_NETWORK, LR_FACTOR = 0.02, 1e-3, 0.99
TRAIN_WEIGHTS = ({"l1": 8e-5, "tv_d": 0.5, "tv_a": 0.25},
                 {"l1": 8e-5, "tv_d": 0.45, "tv_a": 0.2})
TRAIN_SPEC = dict(ortho_weight=1e-3, use_l1=True, use_tv_density=True,
                  use_tv_app=True)
PADDED = (1000, 1024)


def flat(params):
    return _flatten(_numpy_leaves(params))


def estimates(params, inp, mesh, bank):
    """The sharded estimate, unbanked and banked -> {route: outputs}."""
    ro, rd, rr = inp["rays_ori"], inp["rays_dirs"], inp["rays_rgb"]
    return {route: estimate_pose_single_sharded(
        params, ID_CONFIG, inp["img"], inp["mask"], ro, rd, rr, inp["up"],
        mesh, k=K, bank=b, device="cpu")
        for route, b in (("unbanked", None), ("banked", bank))}


def train(field, inp, mesh, batch):
    """Two train steps from the field on the pool's first ``batch`` rows,
    each with its whole batch's jitter -> (params, mse of each step)."""
    config, params, mask = field
    params = trainable(params, torch.device("cpu"))
    opt = trainer.make_optimizer(params, LR_SPATIAL, LR_NETWORK, LR_FACTOR)
    mses = []
    for k, weights in enumerate(TRAIN_WEIGHTS):
        idx = inp["train_idx"][k][:batch]
        mses.append(trainer.train_step(
            config, params, opt, mask, inp["pool_rays"][idx],
            inp["pool_rgbs"][idx], torch.ones(3), weights,
            n_samples=TRAIN_SAMPLES, jitter=inp["train_jitter"][k][:batch],
            mesh=mesh, **TRAIN_SPEC))
    return params, torch.stack(mses)


def pose_dataset(inp):
    return types.SimpleNamespace(
        all_rgbs=inp["frames"], poses=inp["poses"],
        img_wh=tuple(inp["frames"].shape[2:0:-1]), K=inp["K"][None])


def pose_runs(params, inp, mesh, workdir, rank, out):
    """test_pose_estimation with the mesh and without, at a ray count the
    mesh divides and one it does not (the "mesh disabled" route)."""
    for name, n in (("divisible", 1600), ("fallback", 1598)):
        rays = (inp["rays_ori"][:n], inp["rays_dirs"][:n],
                inp["rays_rgb"][:n])
        for tag, m in (("rep", mesh), ("plain", None)):
            logged = []
            rows, *avgs = test_pose_estimation(
                pose_dataset(inp), params, ID_CONFIG, *rays, inp["up"],
                k=K, log_fn=logged.append, mesh=m, save=True,
                save_dir=os.path.join(workdir, f"dump_{name}_{tag}_{rank}"),
                device="cpu")
            out[f"{tag}/pose_{name}/pred_c2w"] = np.asarray(
                [r["pred_c2w"] for r in rows])
            out[f"{tag}/pose_{name}/recall"] = np.asarray(
                [r["recall"] for r in rows])
            out[f"{tag}/pose_{name}/avgs"] = np.asarray(avgs)
            out[f"log/pose_{name}_{tag}"] = np.asarray("\n".join(logged))


def main(workdir: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "rendezvous"),
        rank=rank, world_size=world)
    mesh = make_mesh()
    with np.load(os.path.join(workdir, "inputs.npz")) as f:
        inp = {k: torch.from_numpy(f[k]) for k in f.files}
    params, _ = load_pytree(os.path.join(workdir, "id.npz"), device="cpu")
    field = load_field(os.path.join(workdir, "field.npz"), device="cpu")
    rcfg, rparams, _ = load_field(os.path.join(workdir, "render_field.npz"),
                                  device="cpu")
    ro, rd, rr = inp["rays_ori"], inp["rays_dirs"], inp["rays_rgb"]
    out = {"shard/rank": np.asarray([mesh.rank, mesh.size])}

    for n in PADDED:
        padded, orig = pad_to_multiple(inp[f"pad_{n}"], mesh.size)
        out[f"shard/pad_{n}"] = shard_rays(mesh, padded).numpy()
        out[f"shard/pad_{n}_orig"] = np.asarray(orig)

    bank = ray_bank(params, ID_CONFIG, ro, rd, rr, device="cpu")
    q, pv, _ = image_queries(params, ID_CONFIG, inp["img"], inp["mask"])
    lo, hi = shard_bounds(mesh, ro.shape[0])
    out["shard/score_rays_unbanked"] = score_rays(
        params, ID_CONFIG, q, pv, ro[lo:hi], rd[lo:hi], rr[lo:hi],
        axis_name="data")[0].numpy()
    out["shard/score_rays_banked"] = score_rays(
        params, ID_CONFIG, q, pv, None, None, None, axis_name="data",
        bank=bank[lo:hi])[0].numpy()
    for route, res in estimates(params, inp, mesh, bank).items():
        for name, a in zip(("c2w", "scores", "idx", "weights"), res):
            out[f"rep/estimate_{route}/{name}"] = a.numpy()

    for tag, m in (("rep", mesh), ("plain", None)):
        rgb, depth = render_chunked(
            rcfg, rparams, None, inp["render_rays"], chunk=RENDER_CHUNK,
            n_samples=RENDER_SAMPLES, white_bg=True, mesh=m, device="cpu")
        out[f"{tag}/render/rgb"], out[f"{tag}/render/depth"] = (
            rgb.numpy(), depth.numpy())

    for tag, m in (("rep", mesh), ("plain", None)):
        for batch in (TRAIN_BATCH, UNEVEN_BATCH):
            p, mses = train(field, inp, m, batch)
            out[f"{tag}/train_{batch}/mse"] = mses.numpy()
            for name, a in flat(p).items():
                out[f"{tag}/train_{batch}/{name}"] = a

    pose_runs(params, inp, mesh, workdir, rank, out)

    # a group of one rank (each rank its own) against no mesh
    groups = [dist.new_group([r]) for r in range(world)]
    one = make_mesh(group=groups[rank])
    exact = dataclasses.replace(ID_CONFIG, fused_bank=False)
    for route, res in estimates(params, inp, one, bank).items():
        ref = (estimate_pose_single(params, ID_CONFIG, inp["img"], inp["mask"],
                                    ro, rd, rr, inp["up"], k=K, device="cpu")
               if route == "unbanked" else estimate_pose_single_banked(
                   params, exact, inp["img"], inp["mask"], bank, ro, rd,
                   inp["up"], k=K, device="cpu"))
        for name, a, b in zip(("c2w", "scores", "idx", "weights"), res, ref):
            out[f"one/estimate_{route}/{name}"] = a.numpy()
            out[f"plain/estimate_{route}/{name}"] = b.numpy()
    rgb, depth = render_chunked(
        rcfg, rparams, None, inp["render_rays"], chunk=RENDER_CHUNK,
        n_samples=RENDER_SAMPLES, white_bg=True, mesh=one, device="cpu")
    out["one/render/rgb"], out["one/render/depth"] = rgb.numpy(), depth.numpy()
    p, mses = train(field, inp, one, UNEVEN_BATCH)
    out[f"one/train_{UNEVEN_BATCH}/mse"] = mses.numpy()
    for name, a in flat(p).items():
        out[f"one/train_{UNEVEN_BATCH}/{name}"] = a

    out["log/imports"] = np.asarray(" ".join(sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "iffnerf_tpu"))))
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
