"""Single-image 6DoF pose estimation (reference pose_estimation/
test.py:84-194): image queries -> ray scores -> exact top-k ->
duplicate-origin drop -> weighted LSQ intersection -> negative-ray
reweight -> look-at rotation.

The reference's dynamic ``torch.unique`` dedup becomes a pairwise
origin-equality count, and its NaN/singularity early exits become
``torch.where`` guards, so nothing waits on the host until the caller reads
the result.
"""

from __future__ import annotations

import torch

from iffnerf_tpu_torch.device import as_tensor, resolve_device, tree_to
from iffnerf_tpu_torch.ops.topk import exact_topk
from iffnerf_tpu_torch.parallel.mesh import all_gather, bound, shard_bounds
from iffnerf_tpu_torch.pose.geometry import (
    compute_line_intersection_impl2,
    det3,
    exclude_negatives,
    inv3,
    make_rotation_mat,
)
from iffnerf_tpu_torch.pose.id_module import (
    IDConfig,
    image_queries,
    ray_mlp_inputs,
    run_attention,
    score_rays,
)
from iffnerf_tpu_torch.tracing import span


def _scores_maybe_fused(params, config: IDConfig, img, mask, rays_ori,
                        rays_dirs, rays_rgb):
    """Candidate-ray scores through the fused ray-scoring kernel when
    ``config.fused_scoring`` is set and the kernel takes the shape, else
    through the plain torch chain (as the JAX package falls back to XLA
    where its kernel cannot tile)."""
    if not config.fused_scoring:
        scores, _, _, _ = run_attention(
            params, config, img, mask, rays_ori, rays_dirs, rays_rgb
        )
        return scores
    from iffnerf_tpu_torch.ops import fused_ray_attention as fused

    q, patch_valid, _ = image_queries(params, config, img, mask)
    if not fused.kernel_takes(config.dtype, q.shape[0],
                              fused.layer_widths(params)):
        return score_rays(params, config, q, patch_valid, rays_ori,
                          rays_dirs, rays_rgb)[0]
    with span("pose.score"):
        x = ray_mlp_inputs(config, rays_ori, rays_dirs, rays_rgb)
        return fused.fused_ray_scores(params, q, patch_valid, x)


def solve_pose_from_topk(ori_k: torch.Tensor, dirs_k: torch.Tensor,
                         weights_k: torch.Tensor, model_up: torch.Tensor):
    """Closed-form camera pose from the top-k scored rays
    (reference test.py:133-194). All [k, 3] / [k] inputs; returns c2w [4,4].
    """
    with span("pose.solve"):
        # drop rays sharing an origin with another ray (test.py:133-138):
        # keep i  iff  no j != i has the identical origin
        same = (ori_k[:, None, :] == ori_k[None, :, :]).all(dim=-1)
        keep = same.sum(dim=-1) == 1

        w = weights_k * keep
        w = w / w.sum()
        center = compute_line_intersection_impl2(
            ori_k, dirs_k, weights=keep.to(ori_k.dtype)
        )
        neg = exclude_negatives(center, ori_k, dirs_k)
        w = w * neg
        w = w / w.sum()
        # The reference re-solves with identical arguments after the reweight
        # (test.py:153-155, weights commented out): the center is unchanged,
        # so only the watch direction uses ``w``.

        watch_dir = (dirs_k * w[:, None]).sum(dim=0)
        watch_dir = watch_dir / torch.linalg.norm(watch_dir)

        model_up = model_up / torch.linalg.norm(model_up)
        w2c_rot = make_rotation_mat(-watch_dir, model_up)
        eye3 = torch.eye(3, dtype=w2c_rot.dtype, device=w2c_rot.device)
        w2c_rot = torch.where(det3(w2c_rot).abs() < 1e-7, eye3, w2c_rot)

        c2w = torch.eye(4, dtype=ori_k.dtype, device=ori_k.device)
        c2w[:3, :3] = inv3(w2c_rot)
        c2w[:3, 3] = center

        eye4 = torch.eye(4, dtype=c2w.dtype, device=c2w.device)
        return torch.where(torch.isnan(c2w).any(), eye4, c2w)


def _inputs(device, params, *arrays):
    dev = resolve_device(device)
    return (tree_to(params, dev),) + tuple(
        as_tensor(a, dev, torch.float32) for a in arrays)


@torch.no_grad()
def estimate_pose_single(params, config: IDConfig, img, mask, rays_ori,
                         rays_dirs, rays_rgb, model_up, k: int = 100,
                         device=None):
    """Full single-image estimate on ``device`` (CUDA unless
    ``device="cpu"``). Returns (c2w [4,4], scores [N_rays], topk_idx [k],
    topk_weights [k])."""
    with span("pose.estimate"):
        params, img, mask, rays_ori, rays_dirs, rays_rgb, model_up = _inputs(
            device, params, img, mask, rays_ori, rays_dirs, rays_rgb, model_up)
        scores = _scores_maybe_fused(
            params, config, img, mask, rays_ori, rays_dirs, rays_rgb
        )
        weights_k, idx = exact_topk(scores, k)
        c2w = solve_pose_from_topk(
            rays_ori[idx], rays_dirs[idx], weights_k, model_up
        )
        return c2w, scores, idx, weights_k


@torch.no_grad()
def estimate_pose_single_banked(params, config: IDConfig, img, mask, bank,
                                rays_ori, rays_dirs, model_up, k: int = 100,
                                device=None):
    """Single-image estimate against a precomputed ray bank
    (``id_module.ray_bank``): per image only ViT -> q, the banked scoring,
    top-k and the closed-form solve run. Returns (c2w, scores, topk_idx,
    topk_weights)."""
    with span("pose.estimate"):
        params, img, mask, rays_ori, rays_dirs, model_up = _inputs(
            device, params, img, mask, rays_ori, rays_dirs, model_up)
        bank = bank.to(rays_ori.device)
        q, patch_valid, _ = image_queries(params, config, img, mask)
        scores, _ = score_rays(
            params, config, q, patch_valid, None, None, None, bank=bank
        )
        weights_k, idx = exact_topk(scores, k)
        c2w = solve_pose_from_topk(
            rays_ori[idx], rays_dirs[idx], weights_k, model_up
        )
        return c2w, scores, idx, weights_k


@torch.no_grad()
def estimate_pose_single_sharded(params, config: IDConfig, img, mask,
                                 rays_ori, rays_dirs, rays_rgb, model_up,
                                 mesh, k: int = 100, bank=None, device=None):
    """``estimate_pose_single`` with the candidate rays split over
    ``mesh``'s ranks (``parallel.mesh``; the JAX package's shard_map over
    its 'data' axis). Every rank gets the whole ray set; the image side
    runs replicated; each rank scores its rows on the exact path
    (``score_rays`` with the axis name: two [P]-vector collectives make
    them the full softmax's) and takes its shard's top-k, with global
    indices; the candidates of all ranks are gathered and merged by one
    more exact top-k (lower index first among equal weights) and solved.
    ``bank`` (``id_module.ray_bank`` of the whole set) supplies the keys,
    each rank reading its rows. The ray count must divide by the mesh size
    (540 000 = 20 000 points x 27 directions divides any power of two up
    to 32), and ``k`` must not exceed a shard. Returns (c2w, scores
    [N_rays], topk_idx, topk_weights), the same on every rank."""
    with span("pose.estimate"):
        params, img, mask, rays_ori, rays_dirs, rays_rgb, model_up = _inputs(
            device, params, img, mask, rays_ori, rays_dirs, rays_rgb, model_up)
        n = rays_ori.shape[0]
        if n % mesh.size:
            raise ValueError(f"{n} rays do not divide over {mesh.size} ranks")
        lo, hi = shard_bounds(mesh, n)
        q, patch_valid, _ = image_queries(params, config, img, mask)
        with bound(mesh):
            if bank is not None:
                scores, _ = score_rays(
                    params, config, q, patch_valid, None, None, None,
                    axis_name=mesh.axis, bank=bank.to(rays_ori.device)[lo:hi])
            else:
                scores, _ = score_rays(
                    params, config, q, patch_valid, rays_ori[lo:hi],
                    rays_dirs[lo:hi], rays_rgb[lo:hi], axis_name=mesh.axis)
        w_loc, i_loc = exact_topk(scores, k)
        w_cand = all_gather(w_loc, mesh)
        gidx_cand = all_gather(i_loc + lo, mesh)
        weights_k, sel = exact_topk(w_cand, k)  # merge the shards' top-k's
        idx = gidx_cand[sel]
        c2w = solve_pose_from_topk(
            rays_ori[idx], rays_dirs[idx], weights_k, model_up
        )
        return c2w, all_gather(scores, mesh), idx, weights_k
