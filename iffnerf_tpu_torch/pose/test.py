"""Pose-estimation evaluation harness (reference pose_estimation/test.py:10-268):
per test image run the banked single-image estimate (refined by iNeRF on
request), accumulate the translation and angular errors, the top-100
recall and the score loss, and emit the reference's JSON rows
(test.py:235-247)."""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from iffnerf_tpu_torch.device import as_tensor, resolve_device, tree_to
from iffnerf_tpu_torch.ops.topk import exact_topk
from iffnerf_tpu_torch.parallel.mesh import is_lead, lead_only
from iffnerf_tpu_torch.pose.geometry import (
    compute_angular_error,
    compute_line_intersection_impl2,
    compute_translation_error,
    exclude_negatives,
    make_rotation_mat,
)
from iffnerf_tpu_torch.pose.id_module import (
    IDConfig,
    distance_based_score_loss,
    ray_bank,
)
from iffnerf_tpu_torch.pose.solve import (
    estimate_pose_single_banked,
    estimate_pose_single_sharded,
)


def _solver_debug_intermediates(scores, idx, weights_k, rays_ori, dirs_solve,
                                model_up):
    """The closed-form solver chain with the reference's dynamic shapes, on
    the host, for the debug dump (reference test.py:131-190): rays whose
    origin is shared are DROPPED, giving the variable-length
    ``topk_unique_*`` arrays the reference saves."""
    idx = idx.cpu().numpy()
    weights_k = weights_k.cpu().numpy()
    ori_k = rays_ori.cpu().numpy()[idx]
    dirs_k = dirs_solve.cpu().numpy()[idx]

    _, inverse, counts = np.unique(ori_k, axis=0, return_inverse=True,
                                   return_counts=True)
    keep = counts[inverse.reshape(-1)] == 1
    u_idx, u_w = idx[keep], weights_k[keep]
    ori_u, dirs_u = ori_k[keep], dirs_k[keep]

    w = u_w / u_w.sum()
    center = compute_line_intersection_impl2(
        torch.from_numpy(ori_u), torch.from_numpy(dirs_u)).numpy()
    neg = exclude_negatives(torch.from_numpy(center), torch.from_numpy(ori_u),
                            torch.from_numpy(dirs_u)).numpy()
    w = w * neg
    w = w / w.sum()
    watch = (dirs_u * w[:, None]).sum(0)
    watch = watch / np.linalg.norm(watch)
    rot = make_rotation_mat(torch.from_numpy(-watch),
                            model_up.cpu().float()).numpy()
    if abs(np.linalg.det(rot)) < 1e-7:
        rot = np.eye(3, dtype=rot.dtype)
    c2w = np.eye(4, dtype=ori_u.dtype)
    c2w[:3, :3] = np.linalg.inv(rot)
    c2w[:3, 3] = center
    return {
        "topk_unique_ray_idx": u_idx,
        "topk_unique_weights": u_w,
        "topk_unique_weights_after_exclusion": w,
        "pred_camera_optical_center": center,
        "pred_camera_watch_dir": -watch,
        "pred_c2w_matrix": c2w,
    }


def _timed_ms(fn, dev):
    """(fn(), its time in ms): CUDA events around it, up to a synchronize,
    on the card; the host clock on the CPU."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize(dev)
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


@torch.no_grad()
def test_pose_estimation(dataset, id_params, id_config: IDConfig, rays_ori,
                         rays_dirs, rays_rgb, model_up, sequence_id: str = "",
                         compute_loss: bool = True,
                         inerf_refinement: bool = False, nerf=None,
                         k: int = 100, log_fn=print, mesh=None, save: bool = False,
                         save_all: bool = False, save_dir: str = ".",
                         device=None):
    """Per-frame banked estimates over ``dataset`` on ``device`` (CUDA
    unless ``device="cpu"``). Returns (results, avg_translation_error,
    avg_angular_error, avg_loss_score, avg_recall).

    The bank is built once, from the NEGATED generator directions, and
    every frame is scored and solved with them: the sign the ID module is
    trained on (pose_estimation/train.py:98).

    ``save`` dumps the tensors of image 0 (every image with ``save_all``)
    to ``save_dir/sample_results_<i>.npz`` with the reference's field names
    (test.py:93-105,140-145,178-190). With ``inerf_refinement`` and a
    field ``nerf`` = (config, params, mask), each frame's estimate is
    refined by ``estimate_pose_inerf`` (800 iterations, learning rate 0.02,
    dice loss, random pixels; the JAX package's arguments) before its
    errors are taken; the refinement runs under grad and is not in the
    frame's time.

    With ``mesh`` (``parallel.make_mesh``) each frame's candidate rays are
    split over its ranks (``estimate_pose_single_sharded``, against the
    same bank), where the ray count divides by the mesh size; otherwise
    the mesh is dropped with the JAX package's "pose mesh disabled" line.
    Only the mesh's rank 0 logs and writes ``.npz`` files; every rank
    returns the results. The parameters are the JAX package's, in its
    order, with ``device`` last."""
    lead = is_lead(mesh)
    log_fn = lead_only(mesh, log_fn)
    if mesh is not None and len(rays_ori) % mesh.size != 0:
        log_fn(f"pose mesh disabled: {len(rays_ori)} rays not divisible "
               f"by mesh size {mesh.size}")
        mesh = None
    dev = resolve_device(device)
    id_params = tree_to(id_params, dev)
    rays_ori, rays_dirs, rays_rgb, model_up = (
        as_tensor(a, dev, torch.float32)
        for a in (rays_ori, rays_dirs, rays_rgb, model_up))
    model_up = model_up / torch.linalg.norm(model_up)
    neg_dirs = -rays_dirs
    bank = ray_bank(id_params, id_config, rays_ori, neg_dirs, rays_rgb,
                    device=dev)
    n_patches = id_config.backbone.grid ** 2

    translation_errors, angular_errors = [], []
    recalls, avg_loss_scores, results = [], [], []
    n_images = len(dataset.all_rgbs)
    w, h = dataset.img_wh

    t0 = time.perf_counter()
    warmed = False
    for img_idx in range(n_images):
        pose = as_tensor(dataset.poses[img_idx], dev, torch.float32)
        obs = as_tensor(dataset.all_rgbs[img_idx], dev,
                        torch.float32).reshape(h, w, -1)
        if obs.shape[-1] == 4:
            mask_img = obs[..., -1]
            obs_img = obs[..., :3] * obs[..., -1:] + (1 - obs[..., -1:])
        else:
            mask_img = torch.ones(obs.shape[:-1], dtype=obs.dtype, device=dev)
            obs_img = obs

        def _estimate():
            if mesh is not None:
                return estimate_pose_single_sharded(
                    id_params, id_config, obs_img, mask_img, rays_ori,
                    neg_dirs, rays_rgb, model_up, mesh, k=k, bank=bank,
                    device=dev)
            return estimate_pose_single_banked(
                id_params, id_config, obs_img, mask_img, bank, rays_ori,
                neg_dirs, model_up, k=k, device=dev)

        if not warmed:  # kernel loading outside the per-image timing
            _estimate()
            warmed = True
        (c2w, scores, idx, weights), elapsed_ms = _timed_ms(_estimate, dev)

        avg_score, recall = -1.0, -1.0
        if compute_loss:
            loss, target = distance_based_score_loss(
                scores, pose, rays_ori, neg_dirs, n_patches)
            avg_score = float(loss)
            target_idx = exact_topk(target, k)[1]
            recall = float(torch.isin(target_idx, idx).sum()
                           / target_idx.shape[0])
        avg_loss_scores.append(avg_score)
        recalls.append(recall)

        if save and lead and (img_idx == 0 or save_all):
            dump = {
                "gt_pose": pose.cpu().numpy(),
                "camera_intrinsic": np.asarray(
                    dataset.K[0] if getattr(dataset, "K", None) is not None
                    else np.eye(3)),
                "all_rays_ori": rays_ori.cpu().numpy(),
                "all_rays_dirs": rays_dirs.cpu().numpy(),
                "all_rays_rgb": rays_rgb.cpu().numpy(),
                "obs_img": obs_img.cpu().numpy(),
                "mask_img": mask_img.cpu().numpy(),
                "topk_nonunique_ray_idx": idx.cpu().numpy(),
                "topk_nonunique_weights": weights.cpu().numpy(),
                "all_predict_weights": scores.cpu().numpy(),
                "model_up": model_up.cpu().numpy(),
            }
            if compute_loss:
                dump["all_target_weights"] = target.cpu().numpy()
                dump["loss"] = avg_score
                dump["recall"] = recall
            dump.update(_solver_debug_intermediates(
                scores, idx, weights, rays_ori, neg_dirs, model_up))
            os.makedirs(save_dir, exist_ok=True)
            np.savez(os.path.join(save_dir, f"sample_results_{img_idx}.npz"),
                     **dump)
            log_fn("Sample result saved")

        if inerf_refinement and nerf is not None:
            from iffnerf_tpu_torch.inerf import estimate_pose_inerf

            nerf_config, nerf_params, nerf_mask = nerf
            obs4 = torch.cat([obs_img, mask_img[..., None]], dim=-1)
            _, refined, _ = estimate_pose_inerf(
                c2w, obs4, np.asarray(dataset.K[0]), nerf_config, nerf_params,
                nerf_mask, n_iters=800, lrate=0.02, dice_loss=True,
                sampling_strategy="random", device=dev)
            c2w = as_tensor(refined, dev, torch.float32)

        translation_errors.append(
            float(compute_translation_error(pose[:3, 3], c2w[:3, 3])))
        angular_errors.append(
            float(compute_angular_error(pose[:3, :3], c2w[:3, :3])))
        results.append({
            "sequence_id": sequence_id,
            "category_name": "id_net",
            "frame_id": img_idx,
            "loss": float(torch.mean(weights)),
            "scores_loss": avg_score,
            "recall": recall,
            "total_optimization_time_in_ms": elapsed_ms,
            "pred_c2w": c2w.cpu().numpy().tolist(),
            "gt_c2w": pose.cpu().numpy().tolist(),
        })

    total = time.perf_counter() - t0
    log_fn(f"Average loss score: {np.mean(avg_loss_scores)}")
    log_fn(f"Average Recall: {np.mean(recalls)}")
    log_fn(f"Time per element: {total / max(n_images, 1)}")
    avg_t = float(np.mean(translation_errors))
    avg_a = float(np.mean(angular_errors))
    log_fn(f"Translation Error: {avg_t}")
    log_fn(f"Angular Error: {avg_a}")
    return results, avg_t, avg_a, float(np.mean(avg_loss_scores)), float(
        np.mean(recalls))


# keep pytest from collecting the port function above as a test
test_pose_estimation.__test__ = False
