#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

Builds the port's kernels from ``iffnerf_tpu_torch/csrc``, holds each
against its plain PyTorch version at the main path's shapes, drives the
single-image pose estimate at full width (ViT-S/14 depth 12, 224 crop,
540 000 candidate rays, top-100; random weights from a seed, no
checkpoint) through the entry points a user calls, then the object side:
a field at lego's widths (TensorVMSplit, 300^3 grid, Ref shading, an 8 %
occupied alpha mask; made from the seed, saved and loaded back) through
``explore_field`` (20 000 surface points x 27 isocell directions) and
``test_pose_estimation`` on four synthetic 800x800 frames held in memory
(no image file is read), and ID-module training at full width
(``train_id_module``: float32, accumulation 32, 540 000 rays renewed by
``explore_field``) with a reduced run held against the same run on the
CPU, and TensoRF field training at configs/lego.txt's widths
(``train_field`` from a 128^3 field on 100 synthetic 800x800 frames,
through a mask update with shrink, an upsample, a mask update with ray
filtering and the upsample to 300^3, with ``field_features``' forward
and backward kernels held to their plain versions at the 128^3 and the
final step's samples and on axis-aligned rays and timed there, the
forward also beside F.grid_sample at the final step's samples, an eval
render and a reduced run against the CPU), real scenes (configs/flower.txt
on NDC rays from flower's 34 forward-facing cameras through the LLFF
loader's geometry, 12 steps through its upsamples and mask update to its
706x786x471 grid, then a test view and two path frames; and
configs/bicycle.txt at its 639^3 grid on Mip-NeRF 360 cameras through that
loader's geometry; each with ``field_features``' forward and backward held
to their plain versions at its final step's samples and timed beside their
bounds), object captures (configs/co3d.txt on a CO3D sequence whose
annotation files the CO3D loader reads, through its schedule with its
mask updates to its 300^3-voxel grid, a test view and its mesh through
``export_mesh_from_field``; configs/repair_27_RPf_00192b.txt at its
377x377x188 grid on a Metashape cameras.xml, a test view and a spiral-path
frame; lego's widths under the unisphere contraction; the field kernels
held to their plain versions at each), TensorCP fields (configs/lego.txt
with TensoRF's CP block on the command line, ranks 96/288 trained from
128^3 through its mask updates and upsamples to about 500^3; the CP
forward, line-gradient and coordinate-gradient kernels and K3's backward
held to their plain versions at the final step's samples and at a
colour chunk and timed beside their bounds; a step through the samplers
beside the kernels'; ``explore_field`` and 50 iNeRF iterations on the
trained field, the forward and the coordinate gradient held to their
plain versions at an iteration's samples), and the iNeRF refinement on a
lego-width field with low-frequency appearance (``estimate_pose_inerf``:
800 iterations of 1024 rays from the JAX test's perturbation of a frame
rendered from the field, then ``test_pose_estimation`` with
``inerf_refinement``, its refinement cut to 100 iterations), with
``field_features``' coordinate-gradient
kernel held to its plain version, at an iteration's samples and on an
all-live set, bit-equal across repeats, and timed beside it; and the
data mesh (``parallel/mesh.py``) inside a one-rank NCCL group: the sharded
pose estimate at full width against the exact route and K1's, with
``test_pose_estimation`` through it, the per-object field rendered with
and without the mesh, and three configs/lego.txt steps with
``--data_mesh 1`` and 0, the two held to one another. It checks
what comes out, and times kernels, estimates, the object side,
training steps and refinement iterations with CUDA events and the host
clock. Each
phase prints one JSON line; then come the card's name and power limit (as
nvidia-smi gives them), the kernels line, and last
``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result; so does a run without CUDA or without the package beside it.

    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from iffnerf_tpu_torch.checkpoint import (
    _flatten,
    _numpy_leaves,
    load_field,
    params_from_numpy,
    save_field,
)
from iffnerf_tpu_torch.config import config_parser
from iffnerf_tpu_torch.data import co3d, llff, mip360, repair
from iffnerf_tpu_torch.data.metashape import load_cameras_xml
from iffnerf_tpu_torch.data.rays_np import ray_directions_np
from iffnerf_tpu_torch.device import leaves, resolve_device, trainable
from iffnerf_tpu_torch import inerf as inerf_module
from iffnerf_tpu_torch.inerf import estimate as inerf_estimate
from iffnerf_tpu_torch.inerf.estimate import (
    GeneratorDraws,
    estimate_pose_inerf,
    loop_inputs,
    ray_grids,
)
from iffnerf_tpu_torch.models.field import (
    DENSE_ALPHA_CHUNK,
    FieldConfig,
    get_dense_alpha,
    init_field,
    make_alpha_mask,
    normalize_coord,
    sample_alpha,
    upsample_volume_grid,
)
from iffnerf_tpu_torch.models.render import (
    compute_alpha,
    render_rays,
    sample_point_color_fn,
)
from iffnerf_tpu_torch.ops import _build
from iffnerf_tpu_torch.ops import banked_attention as banked_attention_module
from iffnerf_tpu_torch.ops import cp_features as cp_features_module
from iffnerf_tpu_torch.ops import field_features as field_features_module
from iffnerf_tpu_torch.ops import gather as gather_module
from iffnerf_tpu_torch.ops import grid_sample as grid_sample_module
from iffnerf_tpu_torch.ops.banked_attention import (
    PATCHES,
    banked_scores_fused,
    banked_scores_plain,
)
from iffnerf_tpu_torch.ops.cp_features import (
    cp_features,
    cp_features_backward,
    cp_features_backward_plain,
    cp_features_coords_grad,
    cp_features_coords_grad_plain,
    cp_features_plain,
)
from iffnerf_tpu_torch.ops.field_features import (
    MAT_MODE,
    TABLES,
    VEC_MODE,
    field_features,
    field_features_backward,
    field_features_backward_plain,
    field_features_coords_grad,
    field_features_coords_grad_plain,
    field_features_plain,
    kernel_layout,
)
from iffnerf_tpu_torch.ops.fused_ray_attention import (
    fused_ray_scores,
    fused_ray_scores_plain,
    scaled_queries,
)
from iffnerf_tpu_torch.ops.gather import (
    backward_plan,
    gather_rows,
    gather_rows_backward,
    gather_rows_backward_plain,
    gather_rows_plain,
)
from iffnerf_tpu_torch.ops.grid_sample import corners_1d, corners_2d, corners_3d
from iffnerf_tpu_torch.ops.ide import ide_output_dim
from iffnerf_tpu_torch.ops.topk import exact_topk
from iffnerf_tpu_torch.parallel import make_mesh
from iffnerf_tpu_torch.pose.id_module import (
    IDConfig,
    image_queries,
    init_id_module,
    ray_bank,
    ray_mlp_inputs,
    score_rays,
)
from iffnerf_tpu_torch.pose.model_utils import load_model
from iffnerf_tpu_torch.pose.sampling import (
    evaluate_viewdirs_color,
    explore_field,
    generate_all_possible_rays,
    iterative_surface_sampling_process,
    sampling_epoch,
    samples_points_normals,
)
from iffnerf_tpu_torch.pose.solve import (
    estimate_pose_single,
    estimate_pose_single_banked,
    estimate_pose_single_sharded,
    solve_pose_from_topk,
)
from iffnerf_tpu_torch.pose import trainer as trainer_module
from iffnerf_tpu_torch.pose.geometry import (
    compute_angular_error,
    compute_translation_error,
)
from iffnerf_tpu_torch.pose.test import test_pose_estimation
from iffnerf_tpu_torch.pose.trainer import (
    LEARNING_RATES,
    blend_batch,
    id_train_step,
    leaves,
    make_id_optimizer,
    train_id_module,
    trainable,
)
from iffnerf_tpu_torch.pose.vit import ViTConfig
from iffnerf_tpu_torch.render.renderer import (
    evaluation,
    evaluation_path,
    render_chunked,
)
from iffnerf_tpu_torch.tools.ff_time import AXES, ray_ordered_samples, ray_upstream
from iffnerf_tpu_torch.train import trainer as field_trainer
from iffnerf_tpu_torch.train.trainer import field_config_from_args, train_field
from iffnerf_tpu_torch.utils.mesh import build as build_marching_cubes
from iffnerf_tpu_torch.utils.mesh import export_mesh_from_field, read_ply
from iffnerf_tpu_torch.utils.misc import N_to_reso, cal_n_samples, n_voxel_schedule

SEED = 0
N_RAYS = 20000 * 27      # 20k surface points x 27 isocell directions
RAGGED = 1021            # a ray count no tile divides
K_TOP = 100
N_WARM, N_TIMED = 2, 10  # estimates per route: warm-up, then timed
REPS = 10                # timed batches of kernel calls (median)
BATCH_MAX = 50           # calls a timed batch
N_PROFILE = 3            # profiled estimates per route, colour chunks
N_PROFILE_ITERATIONS = 10  # profiled sampler iterations
# H100 SXM datasheet peaks (dense): bf16 tensor cores, float32 FMA, HBM3;
# TF32 tensor cores, on which K1's float32 route runs three products
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
UP = (0.0, 0.0, 1.0)
# K2 against its plain version, relative (see score_tol): float32 summation
# order; in bf16 an activation's rounding can flip, which moves a score by
# well under 1e-3 of itself (at most 6.7e-4 at 540 000 rays on an H100)
K2_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
# K2's float32 route (three TF32 products a step) against its plain version:
# the largest relative score error. One TF32 product alone gives 1.6e-4 on
# this script's inputs at 540 000 rays on an H100 (tools/k2_time.py
# --variants one_product) and about 2e-5 in
# tests/test_torch_fused_tf32_split.py; three give 1.8e-6
K2_F32_MAX_REL = 5e-6
# the bf16 fused estimate against the plain torch route, another function
# (see phase_fused_estimate): score rtol and least top-100 overlap. Its
# scaled queries differ by a bf16 rounding (2^-9) and a bf16 divisor (19.625
# for sqrt(384), 1.5e-3 off), which move a score by that times its logits'
# spread: at most 1.7e-3 of itself at 540 000 rays on an H100, beside K2's
# own rounding flips (under 1e-3)
PLAIN_ROUTE_RTOL = 3e-3
PLAIN_ROUTE_OVERLAP = 90
# the object side at configs/lego.txt's widths (pose/sampling.py defaults)
GRID = 300
GEN_POINTS, N_EPOCHS, MAX_RESAMPLING = 20000, 4, 200
N_ISOCELL = 27
CHUNK_POINTS = 10240 // N_ISOCELL   # points a colour chunk (379)
CHUNK_SAMPLES = CHUNK_POINTS * N_ISOCELL * 20   # samples a colour chunk
N_FRAMES = 4                         # synthetic 800x800 test frames
# K3's own bench shape (extra/pallas_gather_bench.py:147-152)
BENCH_ROWS, BENCH_COLS, BENCH_N = 90000, 256, 1 << 21
N_FEATURE_SAMPLES = 10 ** 6
# the fused field kernel against its plain version: float32 in another
# order (sigma's sum over ranks), rtol 1e-5 and an atol of 1e-6 x max|plain|
FIELD_RTOL, FIELD_ATOL = 1e-5, 1e-6
# a colour chunk through both kernels against the all-plain route: a
# sample whose ray weight sits at the 1e-4 appearance threshold can flip
# with sigma's rounding and move its ray's rgb by about 1e-4 x |feature|
COLOUR_ATOL = 1e-4
# non-cubic grids with unequal ranks: float4 words, and 4-byte words
NON_CUBIC = {"non_cubic": ((160, 170, 180), (16, 12, 8), (48, 40, 24)),
             "non_cubic_scalar": ((16, 17, 18), (2, 3, 4), (3, 4, 5))}
# ID-module training at the pose CLI's defaults: 1500 iterations, 32 images
# an optimizer step, the rays renewed every 10; a pool of lego's 100 train
# frames. One warm-up step, then ID_TIMED timed steps with a renewal among
# them (renewal every 2 iterations in this run)
ID_ITERS, ID_ACCUM, ID_RENEWAL_EVERY, ID_POOL = 1500, 32, 10, 100
ID_TIMED = 3
# the reduced card-vs-CPU run: ViT depth, rays, accumulation, steps, frames
ID_SMALL_DEPTH, ID_SMALL_RAYS, ID_SMALL_ACCUM, ID_SMALL_STEPS = 2, 8192, 4, 2
ID_SMALL_POOL = 8
# leaves the loss is invariant to (a bias shifting every logit of a patch;
# tests/test_torch_id_train.py): their gradients are noise, bounded apart
ID_INVARIANT = ("k_proj/b", "ray_mlp2/1/b")
# TensoRF training at configs/lego.txt's widths: a pool of lego's 100
# train frames at 800x800 (blender's camera_angle_x), 12 of 30 000
# iterations with the mask updates and upsamples at 3 and 6, from a 128^3
# field; the backward kernel against its plain version within
# FIELD_GRAD_TOL of each leaf's largest |grad| (float32 sums of up to
# thousands of terms a texel, added by atomics in another order than
# autograd's index_add: n x 6e-8 of the terms' magnitudes at worst), the
# plain version in chunks of FT_PLAIN_CHUNK samples
FT_WH, FT_CAMERA_ANGLE_X, FT_POOL = 800, 0.6911112070083618, 100
FT_ITERS, FT_EVENTS, FT_BATCH, FT_GRID_INIT = 12, (3, 6), 4096, 128
FIELD_GRAD_TOL, FT_PLAIN_CHUNK, FT_REPS = 1e-4, 1 << 20, 5
# the backward on axis-aligned rays at the final grid: rays, samples a ray
# (not a multiple of a run, so that runs cross ray ends)
FT_AXIS_RAYS, FT_AXIS_PER_RAY = 4098, 600
# the reduced card-vs-CPU run: grid, upsampled grid, batch, steps
FT_SMALL_GRID, FT_SMALL_UP, FT_SMALL_BATCH, FT_SMALL_STEPS = 32, 40, 256, 3
# iNeRF refinement at test_pose_estimation's settings (pose/test.py): 800
# iterations of 1024 random pixels, lrate 0.02, dice loss, random
# background, on the lego-width field at training's step_ratio 0.5 (about
# 1 040 samples a ray), its appearance factors drawn on an
# INERF_COARSE^3 grid and upsampled; started 12 degrees about z and +0.15
# off the true pose (tests/test_pose_pipeline.py:163-170), both errors to
# end below INERF_GAIN of the start (that test's rule)
INERF_ITERS, INERF_BATCH, INERF_LRATE, INERF_STEP_RATIO = 800, 1024, 0.02, 0.5
INERF_COARSE, INERF_APP_STD = 12, 3.0
INERF_ROT_DEG, INERF_SHIFT, INERF_GAIN = 12.0, 0.15, 0.7
INERF_ROUTE_ITERS, INERF_PROFILE_ITERS = 10, 10
# test_pose_estimation's own refinement (800 iterations, as estimate_pose_
# inerf above runs them) cut to this many: the entry point is driven, the
# 800-iteration loop measured once
INERF_TPE_ITERS = 100
# the coordinate kernel's all-live input: as many samples as an iteration
# (2048 rays x 518 = 1024 x 1036), ray-ordered half a texel apart at the
# field's grid round centres within INERF_LIVE_SPREAD of the origin, every
# upstream word normal
INERF_LIVE_RAYS, INERF_LIVE_PER_RAY, INERF_LIVE_SPREAD = 2048, 518, 0.3
# the coordinate kernel against its plain version, of the largest |dxyz|:
# each coordinate sums up to 3 x 64 rank terms at lego's ranks in another
# order (shuffles against autograd's), n x 6e-8 of their magnitudes at worst
COORDS_GRAD_TOL = 1e-4
# an iteration's (w, v, theta) gradient through both kernels against the
# all-plain route (fused_eval "off", plain gathers), of its largest
# component: sigma's sum over ranks runs in another order, which can move
# a sample across the 1e-4 appearance threshold (as COLOUR_ATOL says)
POSE_GRAD_TOL = 1e-3
# the two routes' poses after INERF_ROUTE_ITERS iterations on the same
# draws: Adam's early steps are about lr x sign(grad), so gradients that
# agree give poses that agree far inside a step (lr 0.02)
POSE_ROUTE_ATOL = 1e-3
# Real scenes. configs/flower.txt (LLFF, NDC rays) on flower's 34
# forward-facing cameras at 4032x3024 (downsample 4: 1008x756, 29 train
# views after the hold-every-8 split), COLMAP's down-right-back poses,
# focal and bounds drawn from the seed; from its 128^3 start (141x157x94
# over the LLFF AABB), cut to RS_FLOWER_ITERS of 25 000 iterations with
# its four upsamples and its mask update (at 2000, 3000, 4000, 5500 and
# 2500) moved to RS_FLOWER_UPSAMPLES and RS_FLOWER_MASK, so that the last
# steps run at its final grid (640^3 voxels: 706x786x471, 2 313 samples a
# ray). configs/bicycle.txt (Mip-NeRF 360) at its final grid (639^3 over
# the unit cube, 2 213 samples a ray) for RS_BICYCLE_STEPS steps, on
# RS_BICYCLE_IMAGES of its 194 cameras at 4946x3286 (downsample 4:
# 1236x821), a ring round a synthetic point cloud, recentred and rescaled
# by the loader's rule. Colours are synthetic, made on the card. One test
# view of each and RS_PATH_FRAMES of flower's 120 path frames rendered.
RS_FLOWER_IMAGES, RS_FLOWER_WH, RS_FLOWER_FOCAL = 34, (4032, 3024), 3260.0
RS_FLOWER_ITERS, RS_FLOWER_UPSAMPLES, RS_FLOWER_MASK = 12, (2, 4, 6, 8), 3
RS_BICYCLE_IMAGES, RS_BICYCLE_WH, RS_BICYCLE_FOCAL = 8, (4946, 3286), 4100.0
RS_BICYCLE_STEPS, RS_PATH_FRAMES, RS_DOWNSAMPLE = 3, 2, 4.0
# Object captures. configs/co3d.txt (CO3D: MLP_Fea, softplus with
# density_shift -10 and distance_scale 25, rm_weight_mask_thre 1e-2, ranks
# 16/48) on a CO3D sequence of OC_CO3D_FRAMES phone-video frames at
# OC_CO3D_WH (downsample_train 5: 384x216, 90 train views) on a ring round
# the object, its annotation files written and read by the loader; from a
# young object field at its 128^3 start through its schedule cut to
# OC_CO3D_ITERS of 30 000 iterations (its five upsamples at 2000-7000 and
# its mask updates at 2000 and 4000 moved to OC_CO3D_UPSAMPLES and
# OC_CO3D_MASKS), then its mesh at its final grid.
# configs/repair_27_RPf_00192b.txt (Repair: MLP_Fea, relu, ranks 16/16/4
# and 48/48/12) on a Metashape cameras.xml of OC_REPAIR_CAMERAS cameras of
# one OC_REPAIR_WH sensor (downsample 5: 400x300, 54 train views) on three
# rings, at its final grid (300^3 voxels over its [[-1,-1,0],[1,1,1]] box:
# 377x377x188) for OC_REPAIR_STEPS steps. The unisphere contraction at
# configs/lego.txt's widths and 300^3 grid, OC_UNI_STEPS steps on
# OC_UNI_FRAMES synthetic 800x800 frames. The capture rigs are tilted by
# OC_RIG_TILT degrees: the loaders' camera-plane fit turns a level rig's
# normal onto +z by a reflection.
OC_CO3D_FRAMES, OC_CO3D_WH, OC_CO3D_FOCAL = 100, (1920, 1080), 1500.0
OC_CO3D_CATEGORY, OC_CO3D_SEQUENCE = "cake", "374_42274_84517"
OC_CO3D_ITERS, OC_CO3D_UPSAMPLES, OC_CO3D_MASKS = 10, (2, 3, 5, 6, 7), (2, 4)
OC_REPAIR_CAMERAS, OC_REPAIR_WH, OC_REPAIR_FOCAL = 60, (2000, 1500), 1800.0
OC_REPAIR_STEPS, OC_DOWNSAMPLE, OC_RIG_TILT = 3, 5.0, 10.0
OC_UNI_STEPS, OC_UNI_FRAMES = 3, 10
# TensorCP fields. TensoRF's CP setting (upstream configs/lego.txt, its
# commented "TensorCP" block: model_name TensorCP, n_lamb_sigma [96],
# n_lamb_sh [288], N_voxel_final 500^3, L1 weight 1e-5 throughout) given
# on the command line over configs/lego.txt, trained on the field_train
# phase's pool and schedule (FT_ITERS iterations, mask updates and
# upsamples at FT_EVENTS) from a 128^3 CP field whose density lines hold a
# blob. The CP line gradient against its plain version within CP_GRAD_TOL
# of each line's largest |grad|: float32 sums of about N / L = 14 000
# terms a texel at the final step, merged in registers and shared memory
# and added by atomics in another order than autograd's index_add (n x
# 6e-8 of the terms' magnitudes at worst); K3's backward against
# index_add_ under the same rule. The samplers' route under grad
# (fused_eval "off": K3 and its backward) runs one step of CP_SAMPLER_RAYS
# rays at the final grid beside the CP kernels' route on the same rays and
# jitter: each leaf's gradient within POSE_GRAD_TOL of its largest (sigma's
# rank sum runs in another order, which can move a sample across the 1e-4
# appearance threshold). CP_INERF_ITERS iterations of estimate_pose_inerf
# on the trained field.
CP_FLAGS = ("--model_name", "TensorCP", "--n_lamb_sigma", "96",
            "--n_lamb_sh", "288", "--N_voxel_final", "125000000",
            "--L1_weight_inital", "1e-5", "--L1_weight_rest", "1e-5")
CP_GRAD_TOL, CP_SAMPLER_RAYS, CP_INERF_ITERS = 1e-4, 256, 50
# K3's backward at wide rows of many rows: a VM plane of lego's
# 300^3 grid, [K3_PLANE^2, 48], at a colour chunk's 4 corners a sample
K3_PLANE = 300
# The CP coordinate kernel's all-live set: an iNeRF iteration's count (1 024
# rays of 1 728 samples, as 2 048 of 864) ray-ordered half a texel apart at
# the trained field's lines, centres within INERF_LIVE_SPREAD of the
# origin, every upstream word normal
CP_LIVE_RAYS, CP_LIVE_PER_RAY = 2048, 864
# The data mesh (parallel/mesh.py) inside a one-rank NCCL group: the
# sharded estimate at full width against the exact route and K1, the
# per-object field rendered at one 800x800 view with and without the mesh
# (rgb and depth within SHARD_RENDER_ATOL), and SHARD_STEPS steps of
# configs/lego.txt (batch 4 096, from a 128^3 field with the cluster mask)
# with --data_mesh 1 and 0 on a pool of SHARD_POOL synthetic frames, the
# parameters held to the CPU tests' training rule (rtol 1e-4, atol 1e-6)
SHARD_STEPS, SHARD_POOL, SHARD_RENDER_ATOL = 3, 10, 1e-6
WORK_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"
T_START = time.perf_counter()


def check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def emit(**kw) -> None:
    """One JSON line; a phase's line also carries the script's seconds so
    far."""
    if "phase" in kw:
        kw["elapsed_s"] = time.perf_counter() - T_START
    print(json.dumps(kw), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = REPS, graph: bool = False) -> float:
    """Median over ``reps`` CUDA-event timings of a batch of back-to-back
    calls of ``fn``, per call, after two warm-ups. A batch holds as many
    calls as fill about a millisecond (at most BATCH_MAX). With ``graph``
    the batch is captured once in a CUDA graph and its replays are timed:
    the device time of the calls' kernels, without the host's launch cost,
    which is larger than a short kernel's own time."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    batch = max(1, min(BATCH_MAX, int(1e-3 / (time.perf_counter() - t0))))

    def run():
        for _ in range(batch):
            fn()

    if graph:
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            run()
        run = captured.replay
    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end) / batch)
    return statistics.median(ts)


def errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    diff = (got - want).abs()
    return {"max_abs_err": float(diff.max()),
            "max_rel_err": float((diff / want.abs().clamp_min(1e-30)).max()),
            "top100": overlap(got, want)}


def score_tol(rtol: float, patch_valid: torch.Tensor, r: int) -> dict:
    """allclose bounds for the scores of ``r`` rays: ``rtol``, and an atol
    of rtol times the mean score. The scores sum to the number of valid
    patches (at most 256), so at 540 000 rays a fixed atol such as 2e-3
    would be many times a typical score and hold nothing."""
    return {"rtol": rtol, "atol": rtol * max(int(patch_valid.sum()), 1) / r}


def overlap(a: torch.Tensor, b: torch.Tensor, k: int = K_TOP) -> int:
    ia = set(exact_topk(a, k)[1].tolist())
    ib = set(exact_topk(b, k)[1].tolist())
    return len(ia & ib)


def blob_mask(h, w, dev):
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    cy, cx = h / 2 + 30, w / 2 - 40
    return ((yy - cy) ** 2 / (h / 4) ** 2 + (xx - cx) ** 2 / (w / 4) ** 2) < 1.0


def make_scene(dev):
    g = torch.Generator(device=dev).manual_seed(SEED)
    ro = torch.rand((N_RAYS, 3), generator=g, device=dev) * 2 - 1
    rd = torch.randn((N_RAYS, 3), generator=g, device=dev)
    rd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    rr = torch.rand((N_RAYS, 3), generator=g, device=dev)
    imgs = torch.rand((N_WARM + N_TIMED, 800, 800, 3), generator=g, device=dev)
    return ro, rd, rr, imgs, blob_mask(800, 800, dev)


# ---------------------------------------------------------------------------
# library yardsticks: the same functions from torch.matmul and elementwise
# calls in the working dtype; timed only, never called by the port
# ---------------------------------------------------------------------------


def library_banked(bank, q, pv):
    # [P, R] logits, softmax over the last axis, as the JAX XLA path lays
    # them out (a softmax over the first axis of [R, P] is ~100x slower)
    logits = torch.matmul(q.to(bank.dtype), bank.T).float() / math.sqrt(bank.shape[1])
    return pv.float() @ torch.softmax(logits, dim=-1)


def library_fused(params, q, pv, x):
    def lin(h, p):
        return torch.matmul(h, p["w"].to(h.dtype)) + p["b"].to(h.dtype)

    h = torch.relu(lin(x, params["ray_mlp"][0]))
    h = torch.relu(lin(h, params["ray_mlp"][1]))
    h = torch.relu(lin(torch.cat([h, x], dim=-1), params["ray_mlp2"][0]))
    k = lin(lin(h, params["ray_mlp2"][1]), params["k_proj"])
    logits = torch.matmul(scaled_queries(q, x.dtype).T, k.T).float()  # [P, R]
    return pv.float() @ torch.softmax(logits, dim=-1)


# ---------------------------------------------------------------------------
# bounds: the least time the card could take, from this run's shapes
# ---------------------------------------------------------------------------


def bound(bytes_: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def banked_bound(bank, q, reads: int = 1):
    """K1's bound with the bank and the products counted ``reads`` times:
    once by the kernels line's rule (each input read once), twice for the
    two passes that an exact kernel needs (the scores need every patch's
    denominator, known only after every ray). A float32 bank's products
    are the three TF32 products of the split, at the TF32 rate. -> (ms,
    bound_by, the bytes alone in ms)."""
    r, d = bank.shape
    p = q.shape[0]
    es = bank.element_size()
    bytes_ = reads * r * d * es + p * d * es + p + r * 4
    flops = reads * 2.0 * r * d * p
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    if bank.dtype == torch.float32:
        t_ops = 3 * flops / PEAK_TF32 * 1e3
        ms, by = ((t_bytes, "bytes") if t_bytes >= t_ops
                  else (t_ops, "operations: three TF32 products"))
    else:
        ms, by = bound(bytes_, flops, bank.dtype)
    return ms, by, t_bytes


def fma_bound_ms(bank, reads: int = 1):
    """The float32 FMA rate's time for K1's products, beside the bound."""
    r, d = bank.shape
    return reads * 2.0 * r * d * 256 / PEAK_FLOPS[torch.float32] * 1e3


def fused_bound(cfg, x, q):
    """K2's bound: x and the weights read once, the scores written once.
    A float32 route's products are the three TF32 products of the split, at
    the TF32 rate. -> (ms, bound_by, the float32 FMA rate's ms or None)."""
    r = x.shape[0]
    p = q.shape[0]
    d, fc, ind = cfg.img_num_features, cfg.ray_feature_c, cfg.ray_in_dim
    layers = [(ind, fc), (fc, fc), (fc + ind, fc), (fc, d), (d, d)]
    macs = sum(i * o for i, o in layers) + d * p
    w_elems = sum(i * o + o for i, o in layers) + d * p
    es = x.element_size()
    bytes_ = x.numel() * es + w_elems * es + p + r * 4
    flops = 2.0 * r * macs
    if x.dtype != torch.float32:
        return (*bound(bytes_, flops, x.dtype), None)
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    t_ops = 3 * flops / PEAK_TF32 * 1e3
    ms, by = ((t_bytes, "bytes") if t_bytes >= t_ops
              else (t_ops, "operations: three TF32 products"))
    return ms, by, flops / PEAK_FLOPS[torch.float32] * 1e3


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    t0 = time.perf_counter()
    built = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = []
    for name in _build.KERNELS:
        log = _build.library_path(name).with_suffix(".so.log")
        if log.exists():
            ptxas += [ln.strip() for ln in log.read_text().splitlines()
                      if any(w in ln for w in ("entry function", "registers",
                                               "spill", "wgmma"))]
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    emit(phase="device", card=card_line(), kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc[-1] if nvcc else None,
         build_s=build_s,
         k1_bf16_clusters=banked_attention_module.resident_clusters(torch.bfloat16),
         k1_float32_clusters=banked_attention_module.resident_clusters(torch.float32),
         nvcc_s={k: round(v, 3) for k, v in built.items()}, ptxas=ptxas)


def _field_features_under_grad(call, config, field, xyz):
    """field_features under grad: one forward launch, one backward launch
    when the loss is differentiated, app_plane[0]'s gradient against the
    plain version's; then with xyz requiring grad too, one coordinate
    launch a backward, xyz's gradient against the plain version's -> the
    shares of FIELD_GRAD_TOL and COORDS_GRAD_TOL the gradients' errors
    take."""
    before = (field_features.launches, field_features_backward.launches)
    sigma, app = call()
    (sigma.sum() + app.square().sum()).backward()
    torch.cuda.synchronize()
    check((field_features.launches, field_features_backward.launches)
          == (before[0] + 1, before[1] + 1),
          "field_features under grad: one forward and one backward launch")
    got = field["app_plane"][0].grad
    with torch.no_grad():
        _, app_plain = field_features_plain(field, xyz, True, gather_rows_plain)
    want = field_features_backward_plain(
        field, xyz, torch.ones_like(sigma), 2 * app_plain)["app_plane"][0]
    share = float((got - want).abs().max()) / (
        FIELD_GRAD_TOL * float(want.abs().max()))
    check(share <= 1.0, f"field_features' gradient under autograd: {share}")
    leaf = xyz.clone().requires_grad_()
    before = (field_features_backward.launches,
              field_features_coords_grad.launches)
    sigma, app = field_features(config, field, leaf, True)
    (sigma.sum() + app.square().sum()).backward()
    torch.cuda.synchronize()
    check((field_features_backward.launches,
           field_features_coords_grad.launches)
          == (before[0] + 1, before[1] + 1),
          "xyz under grad: one table and one coordinate backward launch")
    want_xyz = field_features_coords_grad_plain(
        field, xyz, torch.ones_like(sigma), 2 * app_plain)
    xyz_share = float((leaf.grad - want_xyz).abs().max()) / (
        COORDS_GRAD_TOL * float(want_xyz.abs().max()))
    check(xyz_share <= 1.0, f"the coordinate gradient under autograd: "
          f"{xyz_share}")
    return {"differentiable": True, "grad_share_of_tolerance": share,
            "xyz_grad_share_of_tolerance": xyz_share}


def phase_banked_kernel(params, cfgs, img, mask, rays):
    """K1 against its plain version: f32 and bf16 banks, full and ragged
    ray counts, a mask with invalid patches and an all-invalid one."""
    errs = {}
    for cfg in cfgs:
        bank = ray_bank(params, cfg, *rays)
        q, pv, _ = image_queries(params, cfg, img, mask)
        check(0 < int(pv.sum()) < pv.numel(), "mask leaves some patches invalid")
        for r in (N_RAYS, RAGGED):
            b = bank[:r]
            got = banked_scores_fused(b, q, pv)
            torch.cuda.synchronize()
            want = banked_scores_plain(b, q, pv)
            # rtol 2e-5: float32 accumulation order (tests/test_banked_pose.py)
            tol = score_tol(2e-5, pv, r)
            e = dict(errors(got, want), **tol)
            check(torch.allclose(got, want, **tol),
                  f"K1 {cfg.compute_dtype} R={r}: {e}")
            check(e["top100"] == K_TOP, f"K1 {cfg.compute_dtype} R={r}: {e}")
            if r == N_RAYS:
                # bf16: the pair's two halves of a score land in either
                # order; float32: the four shares are added in rank order
                e["bit_equal_repeat"] = torch.equal(
                    got, banked_scores_fused(b, q, pv))
                check(e["bit_equal_repeat"],
                      f"K1 {cfg.compute_dtype}: two calls bit-equal")
            errs[f"{cfg.compute_dtype}/{r}"] = e
        none = banked_scores_fused(bank[:RAGGED], q, torch.zeros_like(pv))
        check(not bool(none.any()), "K1 all-invalid mask gives zero scores")
    emit(phase="banked_kernel_check", results=errs)
    return errs


def _gather_rows_under_grad(table, idx):
    """K3 under grad: one forward launch, one backward launch when the
    result is differentiated, the table's gradient against index_add_
    within CP_GRAD_TOL of its largest -> the share of the tolerance the
    error takes."""
    before = (gather_rows.launches, gather_rows_backward.launches)
    out = gather_rows(table, idx)
    up = torch.linspace(-1.0, 1.0, out.numel(), device=out.device).view_as(out)
    (out * up).sum().backward()
    torch.cuda.synchronize()
    check((gather_rows.launches, gather_rows_backward.launches)
          == (before[0] + 1, before[1] + 1),
          "gather_rows under grad: one forward and one backward launch")
    want = gather_rows_backward_plain(up, idx, table.shape[0])
    share = float((table.grad - want).abs().max()) / (
        CP_GRAD_TOL * float(want.abs().max()))
    check(share <= 1.0, f"gather_rows' gradient under autograd: {share}")
    return {"differentiable": True, "grad_share_of_tolerance": share}


def phase_guards(params, cfg, img, mask, rays):
    """What the wrappers refuse. K1 and K2 raise under grad with an input
    that requires it (they have no backward), before any launch, and run
    under torch.no_grad(); K3 runs under grad (one forward launch, one
    backward launch on backward, the table's gradient within CP_GRAD_TOL
    of index_add_'s); field_features, which has a backward, runs
    under grad (one forward launch, one backward launch on backward, the
    table's gradient within FIELD_GRAD_TOL of the plain version's; with xyz
    under grad too, one coordinate launch, its gradient within
    COORDS_GRAD_TOL of the plain version's); shapes the banked
    kernel refuses (64 patches, a bf16 depth of 96, a float32 depth of 48)
    go through score_rays to the exact path, with no launch."""
    dev = img.device
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    q, pv, _ = image_queries(params, cfg, img, mask)
    bank = ray_bank(params, cfg, *rays)[:RAGGED].clone().requires_grad_()
    k_proj = dict(params["k_proj"], w=params["k_proj"]["w"].clone().requires_grad_())
    table = torch.randn((GRID * GRID, 16), generator=g, device=dev).requires_grad_()
    idx = torch.randint(0, GRID * GRID, (RAGGED,), generator=g, device=dev,
                        dtype=torch.int32)
    fcfg, field = random_vm_field(*NON_CUBIC["non_cubic"], g, dev)
    field["app_plane"][0].requires_grad_()
    xyz = random_coords(RAGGED, 1.1, g, dev)
    x = ray_mlp_inputs(cfg, *(a[:RAGGED] for a in rays))
    calls = {
        "banked_scores": (banked_scores_fused, lambda: banked_scores_fused(bank, q, pv)),
        "fused_ray_scores": (fused_ray_scores, lambda: fused_ray_scores(
            dict(params, k_proj=k_proj), q, pv, x)),
        "gather_rows": (gather_rows, lambda: gather_rows(table, idx)),
        "field_features": (field_features, lambda: field_features(
            fcfg, field, xyz, True))}
    grad = {}
    for name, (wrapper, call) in calls.items():
        before = wrapper.launches
        if name == "field_features":
            grad[name] = _field_features_under_grad(call, fcfg, field, xyz)
            continue
        if name == "gather_rows":
            grad[name] = _gather_rows_under_grad(table, idx)
            continue
        try:
            call()
            raised = False
        except RuntimeError as err:
            raised = "no backward on CUDA" in str(err)
        check(raised and wrapper.launches == before,
              f"{name} raises under grad before any launch")
        with torch.no_grad():
            call()
        torch.cuda.synchronize()
        check(wrapper.launches == before + 1, f"{name} runs under no_grad")
        grad[name] = {"raised_under_grad": raised, "ran_under_no_grad": True}
    dispatch = {}
    for name, (p, d, dt) in {"p64": (64, 384, torch.float32),
                             "bf16_d96": (PATCHES, 96, torch.bfloat16),
                             "f32_d48": (PATCHES, 48, torch.float32)}.items():
        kbank = torch.randn((N_RAYS, d), generator=g, device=dev).to(dt)
        kq = torch.randn((p, d), generator=g, device=dev).to(dt)
        kpv = torch.rand(p, generator=g, device=dev) > 0.3
        before = banked_scores_fused.launches
        scores, att = score_rays(None, IDConfig(), kq, kpv, None, None, None,
                                 bank=kbank)
        exact, _ = score_rays(None, IDConfig(fused_bank=False), kq, kpv,
                              None, None, None, bank=kbank)
        same = torch.equal(scores, exact)
        check(banked_scores_fused.launches == before and att is not None
              and same, f"score_rays sends {name} to the exact path")
        dispatch[name] = {"exact_path": att is not None, "equal": same,
                          "launches": banked_scores_fused.launches - before}
        del kbank
    emit(phase="guards", grad=grad, refused_shapes=dispatch)


def phase_fused_kernel(params, cfgs, img, mask, rays):
    """K2 against its plain version: f32 and bf16, full and ragged; the
    float32 route also to its largest relative error; both, at the full
    ray count, to two calls bit-equal."""
    errs = {}
    for cfg in cfgs:
        x = ray_mlp_inputs(cfg, *rays)
        q, pv, _ = image_queries(params, cfg, img, mask)
        f32 = cfg.compute_dtype == "float32"
        for r in (N_RAYS, RAGGED):
            got = fused_ray_scores(params, q, pv, x[:r])
            torch.cuda.synchronize()
            want = fused_ray_scores_plain(params, q, pv, x[:r])
            tol = score_tol(K2_RTOL[cfg.compute_dtype], pv, r)
            e = dict(errors(got, want), **tol)
            check(torch.allclose(got, want, **tol),
                  f"K2 {cfg.compute_dtype} R={r}: {e}")
            check(e["top100"] == K_TOP, f"K2 {cfg.compute_dtype} R={r}: {e}")
            if f32:
                check(e["max_rel_err"] <= K2_F32_MAX_REL,
                      f"K2 float32 R={r}: max rel err {e['max_rel_err']}")
            if r == N_RAYS:
                # tiles and partial statistics fold in a fixed order
                e["bit_equal_repeat"] = torch.equal(
                    got, fused_ray_scores(params, q, pv, x[:r]))
                check(e["bit_equal_repeat"],
                      f"K2 {cfg.compute_dtype}: two calls bit-equal")
            errs[f"{cfg.compute_dtype}/{r}"] = e
    emit(phase="fused_kernel_check", results=errs)
    return errs


def _check_pose(c2w, tag):
    check(bool(torch.isfinite(c2w).all()), f"{tag}: c2w finite")
    rot = c2w[:3, :3].double()
    eye = torch.eye(3, dtype=torch.float64, device=rot.device)
    dev_ = float((rot.T @ rot - eye).abs().max())
    check(dev_ < 1e-4, f"{tag}: rotation orthonormal ({dev_})")


def _drive(estimate, imgs):
    """Runs ``estimate(img)`` over the images, host-timed to the end of
    each; -> (outputs, per-image ms of the timed ones)."""
    outs, ms = [], []
    for i in range(imgs.shape[0]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = estimate(imgs[i])
        torch.cuda.synchronize()
        if i >= N_WARM:
            ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    return outs, ms


def _reset_counts():
    banked_scores_fused.launches = 0
    fused_ray_scores.launches = 0
    gather_rows.launches = 0
    field_features.launches = 0
    field_features_backward.launches = 0
    field_features_coords_grad.launches = 0
    gather_rows_backward.launches = 0
    cp_features.launches = 0
    cp_features.launches_by_route = dict.fromkeys(cp_features.launches_by_route, 0)
    cp_features_backward.launches = 0
    cp_features_coords_grad.launches = 0


def _counts():
    return {"banked_scores": banked_scores_fused.launches,
            "fused_ray_scores": fused_ray_scores.launches,
            "gather_rows": gather_rows.launches,
            "field_features": field_features.launches,
            "field_features_backward": field_features_backward.launches,
            "field_features_coords_grad": field_features_coords_grad.launches,
            "gather_rows_backward": gather_rows_backward.launches,
            "cp_features": cp_features.launches,
            **{f"cp_features_{route}": n
               for route, n in cp_features.launches_by_route.items()},
            "cp_features_backward": cp_features_backward.launches,
            "cp_features_coords_grad": cp_features_coords_grad.launches}


def _compare_routes(outs, refs, tag, min_overlap=K_TOP, c2w_tol=1e-4):
    """Checks each estimate's pose, its top-100 overlap with the reference
    estimate's and (unless ``c2w_tol`` is None) their c2w difference;
    -> (largest c2w difference, smallest overlap)."""
    worst, min_ov = 0.0, K_TOP
    for i, ((c2w, s, idx, _), (c2w_r, s_r, idx_r, _)) in enumerate(zip(outs, refs)):
        _check_pose(c2w, f"{tag} image {i}")
        ov = len(set(idx.tolist()) & set(idx_r.tolist()))
        diff = float((c2w - c2w_r).abs().max())
        worst, min_ov = max(worst, diff), min(min_ov, ov)
        check(ov >= min_overlap, f"{tag} image {i}: top-100 overlap {ov}")
        check(c2w_tol is None or diff <= c2w_tol,
              f"{tag} image {i}: c2w differs by {diff}")
    return worst, min_ov


def _score_errors(outs, refs, rtol, patch_valid):
    """Largest abs and rel score differences of the estimates from the
    reference's, and whether all lie within ``score_tol(rtol)``."""
    abs_err, rel_err, ok = 0.0, 0.0, True
    for (_, s, _, _), (_, s_r, _, _) in zip(outs, refs):
        e = errors(s, s_r)
        abs_err = max(abs_err, e["max_abs_err"])
        rel_err = max(rel_err, e["max_rel_err"])
        ok = ok and torch.allclose(s, s_r, **score_tol(rtol, patch_valid,
                                                       s.shape[0]))
    return abs_err, rel_err, ok


def phase_banked_estimate(params, cfg, imgs, mask, rays):
    """The main path: one bank per object, then per-image estimates."""
    ro, rd, rr = rays
    t0 = time.perf_counter()
    bank = ray_bank(params, cfg, ro, rd, rr)
    torch.cuda.synchronize()
    bank_ms = (time.perf_counter() - t0) * 1e3
    _reset_counts()
    outs, ms = _drive(lambda img: estimate_pose_single_banked(
        params, cfg, img, mask, bank, ro, rd, UP, k=K_TOP), imgs)
    counts = _counts()
    check(counts["banked_scores"] == imgs.shape[0],
          f"banked kernel launched once per estimate: {counts}")
    exact = IDConfig(compute_dtype=cfg.compute_dtype, fused_bank=False)
    refs, _ = _drive(lambda img: estimate_pose_single_banked(
        params, exact, img, mask, bank, ro, rd, UP, k=K_TOP), imgs)
    worst, min_ov = _compare_routes(outs, refs, "banked estimate")
    emit(phase="banked_estimate", compute_dtype=cfg.compute_dtype,
         n_rays=N_RAYS, images=imgs.shape[0], launches=counts,
         bank_build_ms=bank_ms, ms_per_image_median=statistics.median(ms),
         ms_per_image=ms, c2w_max_diff_vs_exact=worst, top100_min_overlap=min_ov)
    return counts, statistics.median(ms)


def _estimate_with_plain_k2(params, cfg, img, mask, rays):
    """The fused-scoring estimate with K2's plain version in the kernel's
    place: the same function, to hold the kernel's route to."""
    ro, rd, rr = rays
    q, pv, _ = image_queries(params, cfg, img, mask)
    scores = fused_ray_scores_plain(params, q, pv, ray_mlp_inputs(cfg, ro, rd, rr))
    w, idx = exact_topk(scores, K_TOP)
    up = torch.tensor(UP, dtype=torch.float32, device=ro.device)
    return solve_pose_from_topk(ro[idx], rd[idx], w, up), scores, idx, w


def phase_fused_estimate(params, cfg, imgs, mask, rays):
    """The unbanked route with fused_scoring: the ray chain per image.

    Held to the same estimate through K2's plain version: scores within
    K2's bound, the same top-100, c2w within 1e-4. Held to the plain torch
    route (fused_scoring=False): in float32 the same, as
    tests/test_fused_scoring.py holds the JAX package. In bfloat16 the two
    routes compute different functions: K2 rounds the scaled queries to
    bf16 (the TPU kernel's design) where the plain route divides the
    float32 logits, so scores move by up to PLAIN_ROUTE_RTOL of themselves
    and the near-equal scores of random weights can reorder. There the
    top-100 overlap must reach PLAIN_ROUTE_OVERLAP and c2w is not held."""
    ro, rd, rr = rays
    dt = cfg.compute_dtype
    f32 = dt == "float32"
    fused = IDConfig(compute_dtype=dt, fused_scoring=True)
    pv = image_queries(params, cfg, imgs[0], mask)[1]
    _reset_counts()
    outs, ms = _drive(lambda img: estimate_pose_single(
        params, fused, img, mask, ro, rd, rr, UP, k=K_TOP), imgs)
    counts = _counts()
    same_fn = [_estimate_with_plain_k2(params, cfg, img, mask, rays)
               for img in imgs]
    unfused, plain_ms = _drive(lambda img: estimate_pose_single(
        params, cfg, img, mask, ro, rd, rr, UP, k=K_TOP), imgs)
    k2_abs, k2_rel, k2_ok = _score_errors(outs, same_fn, K2_RTOL[dt], pv)
    plain_rtol = K2_RTOL[dt] if f32 else PLAIN_ROUTE_RTOL
    pl_abs, pl_rel, pl_ok = _score_errors(outs, unfused, plain_rtol, pv)
    emit(phase="fused_estimate", compute_dtype=dt,
         n_rays=N_RAYS, images=imgs.shape[0], launches=counts,
         ms_per_image_median=statistics.median(ms), ms_per_image=ms,
         plain_route_ms_per_image_median=statistics.median(plain_ms),
         score_max_abs_err_vs_plain_k2=k2_abs,
         score_max_rel_err_vs_plain_k2=k2_rel,
         score_max_abs_err_vs_plain_route=pl_abs,
         score_max_rel_err_vs_plain_route=pl_rel)
    check(counts["fused_ray_scores"] == imgs.shape[0],
          f"fused kernel launched once per estimate: {counts}")
    check(k2_ok, f"fused estimate scores vs plain K2 ({dt})")
    check(pl_ok, f"fused estimate scores vs plain route ({dt})")
    worst_k2, _ = _compare_routes(outs, same_fn, "fused estimate vs plain K2")
    worst, min_ov = _compare_routes(
        outs, unfused, "fused estimate vs plain route",
        min_overlap=K_TOP if f32 else PLAIN_ROUTE_OVERLAP,
        c2w_tol=1e-4 if f32 else None)
    emit(phase="fused_estimate_poses", compute_dtype=dt,
         c2w_max_diff_vs_plain_k2=worst_k2,
         c2w_max_diff_vs_plain_route=worst, top100_min_overlap=min_ov)
    return counts, statistics.median(ms)


def _profiled(name, run):
    """torch.profiler over ``run()``, which returns how many units of work
    (images, iterations, chunks) it did -> host ms and kernel ms a unit,
    the device's busy share (kernel time over host time, profiler on), the
    kernels launched a unit and those that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        units = run()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / units
    kernels = sorted(
        (e for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA
         and not getattr(e, "is_user_annotation", False)),
        key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / units
    check(dev_ms > 0, f"profile {name}: the profiler saw device time")
    return {"units": units, "host_ms_per_unit": host_ms,
            "device_ms_per_unit": dev_ms, "device_busy_share": dev_ms / host_ms,
            "kernels_per_unit": sum(e.count for e in kernels) / units,
            "top_kernels_ms_per_unit": {
                e.key[:80]: e.self_device_time_total / 1e3 / units
                for e in kernels[:8]}}


def phase_profile(estimates, imgs):
    """Where an estimate's time goes: a few profiled estimates of each
    route, after one unprofiled (a unit is an image)."""
    out = {}
    for name, fn in estimates.items():
        fn(imgs[0])
        batch = imgs[1:1 + N_PROFILE]

        def run(fn=fn):
            for img in batch:
                fn(img)
            return len(batch)

        out[name] = _profiled(name, run)
    emit(phase="profile", routes=out)
    return out


def phase_times(params, cfgs, img, mask, rays, field, chunk_coords):
    """Kernel, plain and library times at the main path's shapes."""
    rows = gather_times(field, chunk_coords, img.device)
    for cfg in cfgs:
        bank = ray_bank(params, cfg, *rays)
        x = ray_mlp_inputs(cfg, *rays)
        q, pv, _ = image_queries(params, cfg, img, mask)
        b_ms, b_by, b_bytes_ms = banked_bound(bank, q)
        f_ms, f_by, f_fma_ms = fused_bound(cfg, x, q)
        two_ms, _, two_bytes_ms = banked_bound(bank, q, reads=2)
        rows[f"banked_scores/{cfg.compute_dtype}"] = {
            "ms": time_ms(lambda: banked_scores_fused(bank, q, pv)),
            "graph_ms": time_ms(lambda: banked_scores_fused(bank, q, pv),
                                graph=True),
            "plain_ms": time_ms(lambda: banked_scores_plain(bank, q, pv)),
            "library_ms": time_ms(lambda: library_banked(bank, q, pv)),
            "bound_ms": b_ms, "bound_by": b_by, "bound_bytes_ms": b_bytes_ms,
            "bound_two_pass_ms": two_ms,
            "bound_two_pass_bytes_ms": two_bytes_ms}
        if cfg.compute_dtype == "float32":
            rows["banked_scores/float32"].update(
                fma_rate_ms=fma_bound_ms(bank),
                fma_rate_two_pass_ms=fma_bound_ms(bank, reads=2))
        rows[f"fused_ray_scores/{cfg.compute_dtype}"] = {
            "ms": time_ms(lambda: fused_ray_scores(params, q, pv, x)),
            "graph_ms": time_ms(lambda: fused_ray_scores(params, q, pv, x),
                                graph=True),
            "plain_ms": time_ms(lambda: fused_ray_scores_plain(params, q, pv, x)),
            "library_ms": time_ms(lambda: library_fused(params, q, pv, x)),
            "bound_ms": f_ms, "bound_by": f_by}
        if f_fma_ms is not None:
            rows["fused_ray_scores/float32"]["fma_rate_ms"] = f_fma_ms
        del bank, x
        torch.cuda.empty_cache()
    emit(phase="times", n_rays=N_RAYS, reps=REPS, rows=rows)
    return rows


# ---------------------------------------------------------------------------
# the object side: K3 and the field
# ---------------------------------------------------------------------------


def _gather_case(r, c, n, g, dev, aligned=True, edges=()):
    """A random table [r, c] (rows off the 16-byte grid unless ``aligned``)
    and n int32 indices, the first ones ``edges``."""
    buf = torch.randn((r * c + 1,), generator=g, device=dev)
    table = (buf[:-1] if aligned else buf[1:]).view(r, c)
    idx = torch.randint(0, r, (n,), generator=g, device=dev, dtype=torch.int32)
    idx[:len(edges)] = torch.tensor(edges, dtype=torch.int32, device=dev)
    return table, idx


def stacked_mask_corners(n, g, dev):
    """The index array of one mask lookup at ``n`` random points in and
    just beyond the grid: grid_sample_3d's 8 stacked trilinear corners of
    the [300^3, 1] mask volume, corner-major -> [8 n] int32."""
    coords = torch.rand((n, 3), generator=g, device=dev) * 2.1 - 1.05
    return corners_3d(GRID, GRID, GRID, coords)[0].reshape(-1)


def phase_gather_kernel(dev):
    """K3 against its plain version, exactly: K3's bench shape, the field's
    shapes in one colour chunk (planes [300^2, 16 | 48], a line [300, 48],
    the mask [300^3, 1] with 8 random corners a sample, and the mask
    lookup's own stacked corners, one launch a lookup), a ragged count with
    row R - 1, rows off the 16-byte grid, and out-of-range indices (NaN
    rows)."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    plane, line, mask = GRID * GRID, GRID, GRID ** 3
    cases = {
        "bench": (BENCH_ROWS, BENCH_COLS, BENCH_N, True, ()),
        "density_plane": (plane, 16, CHUNK_SAMPLES, True, ()),
        "app_plane": (plane, 48, CHUNK_SAMPLES, True, ()),
        "app_line": (line, 48, CHUNK_SAMPLES, True, ()),
        "mask": (mask, 1, 8 * CHUNK_SAMPLES, True, ()),
        "mask_stacked": (mask, 1, 8 * CHUNK_SAMPLES, True, ()),
        "ragged": (plane, 48, RAGGED, True, (plane - 1,)),
        "unaligned": (plane, 48, CHUNK_SAMPLES, False, (plane - 1,)),
        "edges": (plane, 16, RAGGED, True, (plane, -1, -plane, -plane - 1)),
    }
    out, worst = {}, 0.0
    for name, (r, c, n, aligned, edges) in cases.items():
        table, idx = _gather_case(r, c, n, g, dev, aligned, edges)
        if name == "mask_stacked":
            idx = stacked_mask_corners(CHUNK_SAMPLES, g, dev)
        got = gather_rows(table, idx)
        torch.cuda.synchronize()
        want = gather_rows_plain(table, idx)
        same_nan = torch.equal(got.isnan(), want.isnan())
        err = float((torch.nan_to_num(got) - torch.nan_to_num(want)).abs().max())
        check(same_nan and err == 0.0, f"K3 {name} {r}x{c} N={n}: err {err}")
        worst = max(worst, err)
        out[name] = {"rows": r, "cols": c, "n": n, "max_abs_err": err,
                     "nan_rows": int(got.isnan().any(-1).sum())}
        del table, idx, got, want
    torch.cuda.empty_cache()
    emit(phase="gather_kernel_check", results=out)
    return worst


@contextlib.contextmanager
def plain_gathers():
    """The grid samplers with K3's plain version in the kernel's place: the
    same function, to hold the kernel's route to (a check of this script,
    not an option of the port)."""
    saved = grid_sample_module.gather_rows
    grid_sample_module.gather_rows = gather_rows_plain
    try:
        yield
    finally:
        grid_sample_module.gather_rows = saved


@contextlib.contextmanager
def count_torch_lerps():
    """Counts the calls of the 1-D and 2-D grid samplers of the fields'
    dense routes, VM and CP (texel lerps in torch), while open -> {"n":
    calls}."""
    calls = {"n": 0}
    names = [(field_features_module, "grid_sample_1d"),
             (field_features_module, "grid_sample_2d"),
             (cp_features_module, "grid_sample_1d")]
    saved = [(module, name, getattr(module, name)) for module, name in names]

    def counted(fn):
        def run(*args):
            calls["n"] += 1
            return fn(*args)
        return run

    for module, name, fn in saved:
        setattr(module, name, counted(fn))
    try:
        yield calls
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def cluster_volume(grid, spread, dev):
    """The test fixture's cluster (tests/fixtures.py): a central ball and
    six satellites, on a [grid]^3 lattice over +-1.5, the satellites'
    centres ``spread`` times the fixture's -> bool [grid]^3 (z, y, x)."""
    lin = torch.linspace(-1.5, 1.5, grid, device=dev)
    z, y, x = torch.meshgrid(lin, lin, lin, indexing="ij")
    balls = [((0.0, 0.0, 0.0), 0.22)] + [
        (tuple(0.47 * s * (j == axis) for j in range(3)), 0.125)
        for axis in range(3) for s in (1, -1)]
    vol = torch.zeros((grid,) * 3, dtype=torch.bool, device=dev)
    for (cx, cy, cz), rad in balls:
        vol |= ((x - spread * cx) ** 2 + (y - spread * cy) ** 2
                + (z - spread * cz) ** 2) < (2.85 * rad) ** 2
    return vol


def make_lego_field(dev, grid=GRID, spread=2.5):
    """A TensorVMSplit field at configs/lego.txt's widths, drawn from the
    seed: a ``grid``^3 grid (300 by default), density ranks 16, appearance
    ranks 48, app_dim 27, Ref shading (feature_c 128, view_pe = fea_pe =
    2), AABB +-1.5. The density factors have mean 0.5, so the density
    feature is about 12 and sigma = softplus(12 - 10) about 2 inside the
    mask: the colour pass sees opaque surfaces, as on a trained field. The
    alpha mask is the test fixture's cluster (``cluster_volume``) scaled
    by ``spread``: 2.5 fills the AABB, about 8 % occupied, lego's share.
    -> (config, numpy params, mask)."""
    rng = np.random.default_rng(SEED)
    cfg = FieldConfig(model_name="TensorVMSplit", grid_size=(grid,) * 3,
                      density_n_comp=(16, 16, 16), app_n_comp=(48, 48, 48),
                      app_dim=27, shading_mode="Ref", feature_c=128,
                      view_pe=2, fea_pe=2)

    def normal(shape, mean, std):
        return (mean + std * rng.standard_normal(shape, dtype=np.float32))

    def linear(i, o, bias=True):
        b = 1.0 / math.sqrt(i)
        layer = {"w": rng.uniform(-b, b, (i, o)).astype(np.float32)}
        if bias:
            layer["b"] = rng.uniform(-b, b, (o,)).astype(np.float32)
        return layer

    params = {}
    for kind, comps, mean, std in (("density", cfg.density_n_comp, 0.5, 0.1),
                                   ("app", cfg.app_n_comp, 0.0, 0.1)):
        params[f"{kind}_plane"] = tuple(
            normal((grid, grid, comps[i]), mean, std) for i in range(3))
        params[f"{kind}_line"] = tuple(
            normal((grid, comps[i]), mean, std) for i in range(3))
    params["basis_mat"] = linear(sum(cfg.app_n_comp), cfg.app_dim, bias=False)
    a, fc = cfg.app_dim, cfg.feature_c
    params["shading"] = {
        "diffuse": linear(a, 3), "tint": linear(a, 3),
        "roughness": linear(a, 1), "bottleneck": linear(a, fc),
        "specular": linear(fc + ide_output_dim(4) + 1, 3),
        "normal": linear(a, 3)}

    vol = cluster_volume(grid, spread, dev)
    mask = make_alpha_mask(vol.float(), cfg.aabb_np)
    return cfg, params, mask


def _look_at_c2w(campos):
    """OpenCV-convention c2w of a camera at ``campos`` looking at the
    origin, z up (tests/fixtures.py's cameras)."""
    z = campos / np.linalg.norm(campos)
    x = np.cross([0.0, 0.0, 1.0], z)
    x /= np.linalg.norm(x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, np.cross(z, x), z, campos
    return (c2w @ np.diag([1.0, -1.0, -1.0, 1.0])).astype(np.float32)


def synthetic_frames(dev, n=N_FRAMES):
    """``n`` 800x800 RGBA frames in device memory (random RGB, the blob
    mask as alpha) with cameras on a sphere of radius 4 round the object."""
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    rgb = torch.rand((n, 800, 800, 3), generator=g, device=dev)
    alpha = blob_mask(800, 800, dev).float()[None, ..., None].expand(
        n, 800, 800, 1)
    poses = np.stack([_look_at_c2w(4.0 * np.array(
        [math.cos(t) * math.cos(0.5), math.sin(t) * math.cos(0.5), math.sin(0.5)]))
        for t in np.linspace(0, 2 * math.pi, n, endpoint=False)])
    return types.SimpleNamespace(
        all_rgbs=torch.cat([rgb, alpha], dim=-1), poses=poses,
        img_wh=(800, 800), K=None)


def _sync_s(t0):
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_object(id_params, id_cfg, dev):
    """The object side at lego's widths through the entry points: the field
    saved and loaded back with ``load_model``, ``explore_field`` (counts of
    K3 and field_features launches read right after it, and of the torch
    lerps of the dense route, which must stay 0), a step-by-step rerun for
    the time of each step, the mask lookup held bit-equal to plain gathers,
    one colour chunk and the sampler's alpha through both kernels held to
    the all-plain route, the bank, and ``test_pose_estimation`` on
    synthetic frames. -> (launch counts of ``explore_field``, (config,
    params), the colour chunk's normalized sample coords [204 660, 3])."""
    t0 = time.perf_counter()
    cfg, np_params, mask = make_lego_field(dev)
    occupancy = float(mask.volume.mean())
    check(0.06 < occupancy < 0.10, f"mask occupancy {occupancy}")
    WORK_DIR.mkdir(parents=True, exist_ok=True)
    path = WORK_DIR / "lego_field.npz"
    save_field(str(path), cfg, np_params, mask)
    del np_params, mask
    build_s = _sync_s(t0)
    t0 = time.perf_counter()
    config, params, mask = load_model(str(path))
    load_s = _sync_s(t0)
    path.unlink()
    check(config == cfg, "field config round-trips")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    with count_torch_lerps() as torch_lerps:
        _reset_counts()
        t0 = time.perf_counter()
        ori, dirs, rgb = explore_field(
            gen, config, params, mask, gen_points=GEN_POINTS,
            n_iteration=N_EPOCHS, max_resampling_iterations=MAX_RESAMPLING)
        explore_s = _sync_s(t0)
        counts = _counts()
    explore_peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    n = GEN_POINTS * N_ISOCELL
    for name, a in (("ori", ori), ("dirs", dirs), ("rgb", rgb)):
        check(a.shape == (n, 3), f"explore_field {name} shape {tuple(a.shape)}")
        check(bool(torch.isfinite(a).all()), f"explore_field {name} finite")
    check(counts["field_features"] > 0, f"explore_field launched "
          f"field_features: {counts}")
    check(0 < counts["gather_rows"] < 1000, f"explore_field launched K3, "
          f"once a mask lookup: {counts}")
    check(torch_lerps["n"] == 0, f"no texel lerp of the VM field in torch "
          f"({torch_lerps['n']} sampler calls)")
    norm_err = float((torch.linalg.norm(dirs, dim=-1) - 1).abs().max())
    check(norm_err < 1e-4, f"unit directions ({norm_err})")
    check(float(rgb.min()) >= 0 and float(rgb.max()) <= 1, "rgb in [0, 1]")
    voxel = float(np.max(config.units))
    aabb = torch.as_tensor(config.aabb_np, device=dev)
    pts = ori[::N_ISOCELL]
    check(bool(((pts >= aabb[0] - voxel) & (pts <= aabb[1] + voxel)).all()),
          "surface samples inside the AABB")
    alpha_pts = compute_alpha(config, params, mask, pts, 1.0)
    uniform = torch.rand((GEN_POINTS, 3), generator=gen, device=dev) * 3 - 1.5
    alpha_uni = compute_alpha(config, params, mask, uniform, 1.0)
    check(float(alpha_pts.median()) > float(alpha_uni.median()),
          "surface samples denser than uniform points")

    # the same steps one by one, for the time of each
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    samples, epochs = iterative_surface_sampling_process(
        gen, config, params, mask, gen_points=GEN_POINTS, n_iteration=N_EPOCHS,
        max_resampling_iterations=MAX_RESAMPLING)
    sampling_s = _sync_s(t0)
    t0 = time.perf_counter()
    normals = samples_points_normals(config, params, samples)
    normals_s = _sync_s(t0)
    t0 = time.perf_counter()
    generate_all_possible_rays(config, params, mask, samples, normals)
    colours_s = _sync_s(t0)

    # one colour chunk and the sampler's proposals: the mask lookup through
    # K3 bit-equal to plain gathers; rgb and alpha through both kernels
    # against the all-plain route (plain gathers, fused_eval "off")
    c_pts = ori[:CHUNK_POINTS * N_ISOCELL].reshape(CHUNK_POINTS, N_ISOCELL, 3)
    c_dirs = dirs[:CHUNK_POINTS * N_ISOCELL].reshape(CHUNK_POINTS, N_ISOCELL, 3)
    chunk_xyz = sample_point_color_fn(config, c_pts.reshape(-1, 3),
                                      c_dirs.reshape(-1, 3), n_samples=20)[0]
    proposals = (pts[:, None] + 0.05 * torch.randn(
        (GEN_POINTS, 5, 3), generator=gen, device=dev)).reshape(-1, 3)
    for name, xyz in (("colour chunk", chunk_xyz), ("proposals", proposals)):
        got = sample_alpha(mask, xyz)
        with plain_gathers():
            want = sample_alpha(mask, xyz)
        check(torch.equal(got, want), f"mask lookup at the {name}: K3 "
              f"bit-equal to plain gathers ({float((got - want).abs().max())})")
    plain_cfg = dataclasses.replace(config, fused_eval="off")
    got = (evaluate_viewdirs_color(config, params, mask, c_pts, c_dirs),
           compute_alpha(config, params, mask, proposals, 1.0))
    with plain_gathers():
        want = (evaluate_viewdirs_color(plain_cfg, params, mask, c_pts, c_dirs),
                compute_alpha(plain_cfg, params, mask, proposals, 1.0))
    route_errs = {}
    for name, a, b, atol in (("rgb", got[0], want[0], COLOUR_ATOL),
                             ("alpha", got[1], want[1], FIELD_ATOL)):
        route_errs[f"{name}_max_abs_err"] = float((a - b).abs().max())
        route_errs[f"{name}_bit_equal"] = bool(torch.equal(a, b))
        check(torch.allclose(a, b, rtol=FIELD_RTOL, atol=atol),
              f"{name} through both kernels vs the all-plain route: "
              f"{route_errs}")
    alpha_pos = float((got[1] > 0).float().mean())
    chunk_coords = normalize_coord(config, chunk_xyz).reshape(-1, 3)
    del got, want, proposals, chunk_xyz

    # where the object side's time goes: sampler iterations (from the
    # surface samples, where the loop runs to its cap) and colour chunks
    rho = float(np.max(config.grid_size) * 0.1
                * np.max(config.aabb_size / np.asarray(config.grid_size)))
    object_profile = {
        "sampler_iteration": _profiled("sampler", lambda: sampling_epoch(
            gen, config, params, mask, pts, alpha_pts, rho,
            max_iterations=N_PROFILE_ITERATIONS)[2]),
        "colour_chunk": _profiled("colours", lambda: len([
            evaluate_viewdirs_color(config, params, mask, c_pts, c_dirs)
            for _ in range(N_PROFILE)]))}
    emit(phase="object_profile", **object_profile)

    t0 = time.perf_counter()
    ray_bank(id_params, id_cfg, ori, -dirs, rgb)
    bank_s = _sync_s(t0)
    frames = synthetic_frames(dev)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    rows, t_err, a_err, loss, recall = test_pose_estimation(
        frames, id_params, id_cfg, ori, dirs, rgb, torch.tensor(UP),
        sequence_id="lego", log_fn=lambda *a: None)
    pose_peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    k1_launches = banked_scores_fused.launches
    check(len(rows) == N_FRAMES, "a row per frame")
    check(k1_launches == N_FRAMES + 1, f"K1 once per frame and warm-up: "
          f"{k1_launches}")
    for r in rows:
        _check_pose(torch.tensor(r["pred_c2w"]), f"frame {r['frame_id']}")
        check(0.0 <= r["recall"] <= 1.0 and math.isfinite(r["scores_loss"]),
              f"frame {r['frame_id']} recall and loss")
    frame_ms = [r["total_optimization_time_in_ms"] for r in rows]
    emit(phase="object", grid=GRID, occupancy=occupancy, n_rays=n,
         field_build_s=build_s, field_load_s=load_s, explore_field_s=explore_s,
         launches=counts, torch_lerp_calls=torch_lerps["n"],
         chunk_vs_all_plain=route_errs, sampling_s=sampling_s,
         sampler_iterations=[it for it, _ in epochs],
         sampler_left_invalid=[k for _, k in epochs], normals_s=normals_s,
         colours_s=colours_s, bank_s=bank_s,
         proposal_alpha_positive_share=alpha_pos,
         explore_peak_mem_gb=explore_peak_gb, pose_peak_mem_gb=pose_peak_gb,
         frames=N_FRAMES, banked_scores_launches=k1_launches,
         frame_ms=frame_ms, frame_ms_median=statistics.median(frame_ms),
         translation_error=t_err, angular_error=a_err, scores_loss=loss,
         recall=recall)
    return counts, (config, params), mask, chunk_coords


def gather_bound(table, idx):
    """Bytes: each table row the indices touch read once, the indices, the
    output written once."""
    c = table.shape[1]
    rows = torch.unique(idx).numel()
    return bound(rows * c * 4 + idx.numel() * 4 + idx.numel() * c * 4, 0.0,
                 torch.float32)


def random_vm_field(grid, ranks_density, ranks_app, g, dev):
    """A TensorVMSplit field of the given grid (x, y, z) and ranks, drawn
    from ``g`` -> (config, params): planes [g[m1], g[m0], R], lines
    [g[vec], R]."""
    config = FieldConfig(grid_size=grid, density_n_comp=ranks_density,
                         app_n_comp=ranks_app)
    params = {}
    for kind, ranks in (("density", ranks_density), ("app", ranks_app)):
        params[f"{kind}_plane"] = tuple(
            0.5 + 0.1 * torch.randn((grid[m1], grid[m0], ranks[i]),
                                    generator=g, device=dev)
            for i, (m0, m1) in enumerate(MAT_MODE))
        params[f"{kind}_line"] = tuple(
            0.5 + 0.1 * torch.randn((grid[VEC_MODE[i]], ranks[i]),
                                    generator=g, device=dev)
            for i in range(3))
    return config, params


def random_coords(n, spread, g, dev):
    """[n, 3] normalized coords uniform in [-spread, spread], the first
    ones on the grid's faces, corners and centre."""
    xyz = (torch.rand((n, 3), generator=g, device=dev) * 2 - 1) * spread
    edges = torch.tensor([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0], [0.0, 0.0, 0.0],
                          [1.0, -1.0, 0.5], [-1.0, 1.0, -0.25]], device=dev)
    xyz[:min(n, 5)] = edges[:min(n, 5)]
    return xyz


def _field_errors(config, params, xyz, with_app):
    """field_features against its plain version on plain gathers (the grid
    samplers in pure torch): max abs errors, max |plain|, bit-equality;
    raises beyond FIELD_RTOL and FIELD_ATOL x max|plain|, or when the app
    products are not bit-equal."""
    got = field_features(config, params, xyz, with_app)
    torch.cuda.synchronize()
    with plain_gathers():
        want = field_features_plain(params, xyz, with_app)
    out = {}
    for name, a, b in zip(("sigma", "app"), got, want):
        if b is None:
            continue
        check(a.shape == b.shape, f"field_features {name} shape {a.shape}")
        scale = float(b.abs().max()) if b.numel() else 0.0
        out[name] = {"max_abs_err": float((a - b).abs().max()) if b.numel() else 0.0,
                     "max_abs_plain": scale, "bit_equal": bool(torch.equal(a, b))}
        check(torch.allclose(a, b, rtol=FIELD_RTOL, atol=FIELD_ATOL * scale),
              f"field_features {name} vs plain: {out[name]}")
    check("app" not in out or out["app"]["bit_equal"],
          f"field_features app products bit-equal to plain: {out.get('app')}")
    return out


def phase_field_kernel(field, chunk_coords, dev):
    """field_features against its plain version, density-only and with
    appearance: a colour chunk's samples on the lego-width field, 10^6
    random samples in and beyond [-1, 1], and non-cubic grids with unequal
    ranks (float4 words, and 4-byte words). -> the largest abs error at
    the colour chunk."""
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    config, params = field
    cases = {"colour_chunk": (config, params, chunk_coords),
             "uniform_1e6": (config, params,
                             random_coords(N_FEATURE_SAMPLES, 1.2, g, dev))}
    for name, (grid, rd, ra) in NON_CUBIC.items():
        cfg, p = random_vm_field(grid, rd, ra, g, dev)
        cases[name] = (cfg, p, random_coords(100_000, 1.1, g, dev))
    out = {}
    for name, (cfg, p, xyz) in cases.items():
        out[name] = {"n": xyz.shape[0],
                     "density": _field_errors(cfg, p, xyz, False),
                     "both": _field_errors(cfg, p, xyz, True)}
    emit(phase="field_kernel_check", rtol=FIELD_RTOL,
         atol_per_max_plain=FIELD_ATOL, results=out)
    chunk = out["colour_chunk"]["both"]
    return max(chunk["sigma"]["max_abs_err"], chunk["app"]["max_abs_err"])


def field_bound(params, xyz, with_app):
    """Bytes: the coordinates read and the features written once, each
    plane and line row the samples touch read once -> (bound ms, bound_by,
    the bytes of the corner reads that L1 and L2 serve)."""
    n = xyz.shape[0]
    _, dims = kernel_layout(params, with_app)
    touched = corner = 0
    for i in range(3):
        h, w, length, rd, ra = dims[5 * i:5 * i + 5]
        m0, m1 = MAT_MODE[i]
        plane_idx = corners_2d(h, w, torch.stack([xyz[:, m0], xyz[:, m1]], -1))[0]
        line_idx = corners_1d(length, xyz[:, VEC_MODE[i]])[0]
        row = (rd + ra) * 4
        touched += (torch.unique(plane_idx).numel()
                    + torch.unique(line_idx).numel()) * row
        corner += n * 6 * row
    ms, by = bound(n * 12 + n * 4 + n * dims[-1] * 4 + touched, 0.0,
                   torch.float32)
    return ms, by, corner


def library_tables(params):
    """The planes as [1, R, H, W] and the lines as [1, R, L, 1], the layout
    F.grid_sample takes."""
    return {kind: [(params[f"{kind}_plane"][i].permute(2, 0, 1)[None].contiguous(),
                    params[f"{kind}_line"][i].T[None, :, :, None].contiguous())
                   for i in range(3)]
            for kind in ("density", "app")}


def library_features(tables, coords, with_app):
    """field_features' function from F.grid_sample (a timing yardstick; the
    port never calls it) -> (sigma feature [N], app products [N, sum(R)]
    or None)."""
    zero = torch.zeros_like(coords[:, 0])
    grids = [(torch.stack([coords[:, m0], coords[:, m1]], -1)[None, :, None],
              torch.stack([zero, coords[:, VEC_MODE[i]]], -1)[None, :, None])
             for i, (m0, m1) in enumerate(MAT_MODE)]

    def products(kind):
        return [F.grid_sample(plane, pc, align_corners=True)[0, :, :, 0]
                * F.grid_sample(line, lc, align_corners=True)[0, :, :, 0]
                for (plane, line), (pc, lc) in zip(tables[kind], grids)]

    sigma = sum(p.sum(0) for p in products("density"))
    return sigma, torch.cat(products("app"), 0).T if with_app else None


def gather_times(field, chunk_coords, dev):
    """K3, its plain version and ``torch.index_select`` (the one PyTorch
    call of the same function, timed only) at K3's bench shape, at the
    mask lookup's stacked corners (the shape K3 serves on the path) and at
    the app-plane shape of the dense route. field_features, its plain
    version (pure torch), the dense route through K3 and an F.grid_sample
    composition at a colour chunk and at 10^6 random samples, density-only
    and with appearance."""
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    rows = {}
    for name, (r, c, n) in (("bench", (BENCH_ROWS, BENCH_COLS, BENCH_N)),
                            ("mask_stacked", (GRID ** 3, 1, 8 * CHUNK_SAMPLES)),
                            ("app_plane", (GRID * GRID, 48, CHUNK_SAMPLES))):
        table, idx = _gather_case(r, c, n, g, dev)
        if name == "mask_stacked":
            idx = stacked_mask_corners(CHUNK_SAMPLES, g, dev)
        b_ms, b_by = gather_bound(table, idx)
        rows[f"gather_rows/{name}"] = {
            "rows": r, "cols": c, "n": n,
            "ms": time_ms(lambda: gather_rows(table, idx), graph=True),
            "eager_ms": time_ms(lambda: gather_rows(table, idx)),
            "plain_ms": time_ms(lambda: gather_rows_plain(table, idx)),
            "library_ms": time_ms(lambda: torch.index_select(table, 0, idx),
                                  graph=True),
            "bound_ms": b_ms, "bound_by": b_by}
        del table, idx

    config, params = field
    tables = library_tables(params)
    coords = random_coords(N_FEATURE_SAMPLES, 1.0, g, dev)
    for name, xyz in (("colour_chunk", chunk_coords), ("uniform_1e6", coords)):
        for mode, with_app in (("density", False), ("both", True)):
            ours = field_features(config, params, xyz, with_app)
            lib = library_features(tables, xyz, with_app)
            diff = max(float((a - b).abs().max() / b.abs().max())
                       for a, b in zip(ours, lib) if b is not None)
            check(diff < 1e-5, f"F.grid_sample yardstick computes the same "
                  f"({diff})")
            del ours, lib
            b_ms, b_by, corner_bytes = field_bound(params, xyz, with_app)
            row = {"n": xyz.shape[0],
                   "ms": time_ms(lambda: field_features(config, params, xyz,
                                                        with_app), graph=True),
                   "eager_ms": time_ms(lambda: field_features(
                       config, params, xyz, with_app)),
                   "dense_k3_ms": time_ms(lambda: field_features_plain(
                       params, xyz, with_app))}
            with plain_gathers():
                row["plain_ms"] = time_ms(lambda: field_features_plain(
                    params, xyz, with_app))
            row.update(library_ms=time_ms(lambda: library_features(
                tables, xyz, with_app), graph=True), bound_ms=b_ms, bound_by=b_by,
                corner_read_bytes=corner_bytes, library_max_rel_diff=diff)
            rows[f"field_features/{name}/{mode}"] = row
            torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# ID-module training
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def timed_id_steps():
    """Times the trainer's optimizer steps while open (the loop looks the
    step up in its module each iteration) -> a list with, for each step,
    its host seconds up to a synchronize, its loss and its peak device
    memory."""
    steps = []
    step = trainer_module.id_train_step

    def timed(*args, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = step(*args, **kw)
        steps.append({"s": _sync_s(t0), "loss": float(loss),
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
        return loss

    trainer_module.id_train_step = timed
    try:
        yield steps
    finally:
        trainer_module.id_train_step = step


def _step_split(params, cfg, frames, rays, dev):
    """Two more optimizer steps through ``id_train_step``: one with CUDA
    events at its marks -> device ms of each part (ray features forward,
    the per-image losses and their gradients, the ray MLP's backward,
    Adam); one under the profiler -> host and kernel ms an image, the busy
    share and the kernels that take the most device time."""
    p = trainable(params, dev)
    opt = make_id_optimizer(p)
    row = torch.as_tensor(np.random.default_rng(SEED + 5).integers(
        0, ID_POOL, ID_ACCUM), device=dev)
    imgs, masks = blend_batch(frames.all_rgbs[row])
    poses = torch.as_tensor(frames.poses, device=dev)[row]
    events = [("start", torch.cuda.Event(enable_timing=True))]
    events[0][1].record()

    def mark(label):
        events.append((label, torch.cuda.Event(enable_timing=True)))
        events[-1][1].record()

    id_train_step(p, opt, imgs, masks, poses, rays[0], -rays[1], rays[2], cfg,
                  ID_ACCUM, mark=mark)
    torch.cuda.synchronize()
    split = {f"{label}_ms": a.elapsed_time(b)
             for (_, a), (label, b) in zip(events, events[1:])}
    split["per_image_ms"] = split["image_losses_ms"] / ID_ACCUM

    def step():
        id_train_step(p, opt, imgs, masks, poses, rays[0], -rays[1], rays[2],
                      cfg, ID_ACCUM)
        return ID_ACCUM

    split["profile_per_image"] = _profiled("id_train_step", step)
    return split


def _params_close(ref, new):
    """The CPU parity tests' rule (tests/test_torch_id_train.py), at each
    leaf's own rate: rtol 1e-3 and atol max(5e-5, 0.1 lr); the invariant
    leaves within 2.1 x steps x lr. -> the largest share of its bound that
    a leaf's difference takes (at most 1 when all hold), and that leaf."""
    ref, new = (_flatten(_numpy_leaves(p)) for p in (ref, new))
    worst = (0.0, "")
    for name, a in ref.items():
        lr = LEARNING_RATES[name.split("/")[0]]
        diff = np.abs(new[name] - a)
        if name in ID_INVARIANT:
            share = float(diff.max()) / (2.1 * ID_SMALL_STEPS * lr)
        else:
            share = float((diff / (max(5e-5, 0.1 * lr)
                                   + 1e-3 * np.abs(a))).max())
        worst = max(worst, (share, name))
    return worst


def phase_id_train(field, mask, dev):
    """ID-module training through ``train_id_module`` at full width:
    DINOv2 ViT-S/14 depth 12 in float32, 540 000 rays from ``explore_field``
    on the lego-width field, 32 images a step from a pool of 100 synthetic
    800x800 RGBA frames, random weights from the seed. One warm-up step and
    ID_TIMED timed steps, renewals at iterations 0 and 2 (so one lies in
    the timed span); launch counts set to 0 before the run and read after
    it. Then the split of one step, and a reduced run (depth 2, 8 192 rays,
    accumulation 4, 2 steps) on the card and on the CPU from the same
    parameters, index rows and rays, held to the CPU parity tests' rule.
    -> the run's launch counts."""
    config, fparams = field
    cfg = IDConfig()
    check(cfg.compute_dtype == "float32", "training is float32")
    init = init_id_module(torch.Generator().manual_seed(SEED), cfg, device=dev)
    frames = synthetic_frames(dev, ID_POOL)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    renewals, last = [], {}

    def renew():
        before = _counts()
        t0 = time.perf_counter()
        last["rays"] = explore_field(
            gen, config, fparams, mask, gen_points=GEN_POINTS,
            n_iteration=N_EPOCHS, max_resampling_iterations=MAX_RESAMPLING,
            device=dev)
        renewals.append({"s": _sync_s(t0), "launches": {
            k: v - before[k] for k, v in _counts().items()}})
        return last["rays"]

    with timed_id_steps() as steps:
        _reset_counts()
        t0 = time.perf_counter()
        trained, model_up = train_id_module(
            init, cfg, renew, frames, frames, n_iterations=1 + ID_TIMED,
            gradient_accumulation_steps=ID_ACCUM, renewal_every_n_iterations=2,
            rng=np.random.default_rng(SEED), log_fn=lambda *a: None,
            device=dev)
        run_s = _sync_s(t0)
        counts = _counts()
    n = GEN_POINTS * N_ISOCELL
    check(len(steps) == 1 + ID_TIMED and len(renewals) == 2,
          f"{len(steps)} steps and {len(renewals)} renewals")
    check(last["rays"][0].shape == (n, 3), "540 000 rays a renewal")
    losses = [st["loss"] for st in steps]
    check(all(math.isfinite(x) for x in losses), f"finite losses {losses}")
    check(all(a != b for a, b in zip(losses, losses[1:])),
          f"the loss changes from step to step {losses}")
    check(all(bool(torch.isfinite(t).all()) for t in leaves(trained)),
          "finite trained parameters")
    moved = max(float((a - b).abs().max())
                for a, b in zip(leaves(trained), leaves(init)))
    check(moved > 0, "the parameters moved")
    check(counts["banked_scores"] == 0 and counts["fused_ray_scores"] == 0,
          f"training scores with the exact torch path: {counts}")
    for r in renewals:
        check(r["launches"]["gather_rows"] > 0
              and r["launches"]["field_features"] > 0,
              f"a renewal launched K3 and field_features: {r}")
    timed = [st["s"] for st in steps[1:]]
    step_s = statistics.median(timed)
    renewal_s = renewals[1]["s"]
    n_renewals = ID_ITERS // ID_RENEWAL_EVERY
    split = _step_split(trained, cfg, frames, last["rays"], dev)
    share = n_renewals * renewal_s / (n_renewals * renewal_s
                                      + ID_ITERS * step_s)
    small = phase_id_train_small(init, frames, last["rays"], dev)
    emit(phase="id_train", depth=cfg.backbone.depth, n_rays=n,
         accum_steps=ID_ACCUM, pool=ID_POOL, steps=len(steps),
         warmup_step_s=steps[0]["s"], step_s=timed, step_s_median=step_s,
         step_s_range=[min(timed), max(timed)], losses=losses,
         peak_mem_gb=max(st["peak_mem_gb"] for st in steps),
         peak_mem_gb_by_step=[st["peak_mem_gb"] for st in steps],
         split=split, renewal_s=[r["s"] for r in renewals],
         renewal_launches=[r["launches"] for r in renewals],
         run_s=run_s, launches=counts,
         run_of_1500_s=ID_ITERS * step_s + n_renewals * renewal_s,
         renewal_share_of_1500=share, largest_param_move=moved,
         model_up=model_up.tolist(), card_vs_cpu=small)
    return counts


def phase_id_train_small(init, frames, rays, dev):
    """The reduced run on the card and on the CPU: a depth-2 ViT (the first
    two blocks of the full-width initialisation), the first 8 192 rays, 4
    images a step from 8 frames, 2 steps, the same index rows -> the
    largest share of the tolerance a leaf takes, and the run's seconds on
    each device."""
    cfg = IDConfig(backbone=ViTConfig(depth=ID_SMALL_DEPTH))
    init = dict(init, backbone=dict(
        init["backbone"], blocks=init["backbone"]["blocks"][:ID_SMALL_DEPTH]))
    init = trainable(init, torch.device("cpu"))
    rays = tuple(a[:ID_SMALL_RAYS].cpu() for a in rays)
    pool = types.SimpleNamespace(
        all_rgbs=frames.all_rgbs[:ID_SMALL_POOL].cpu(),
        poses=frames.poses[:ID_SMALL_POOL], img_wh=frames.img_wh)
    out, secs = {}, {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        out[name], _ = train_id_module(
            init, cfg, lambda: rays, pool, pool, n_iterations=ID_SMALL_STEPS,
            gradient_accumulation_steps=ID_SMALL_ACCUM,
            rng=np.random.default_rng(SEED), log_fn=lambda *a: None,
            device=device)
        secs[name] = _sync_s(t0)
    worst, leaf = _params_close(out["cpu"], out["card"])
    check(worst <= 1.0, f"card and CPU parameters agree after "
          f"{ID_SMALL_STEPS} steps (worst share of the bound {worst}, {leaf})")
    return {"depth": ID_SMALL_DEPTH, "n_rays": ID_SMALL_RAYS,
            "accum_steps": ID_SMALL_ACCUM, "steps": ID_SMALL_STEPS,
            "worst_share_of_tolerance": worst, "worst_leaf": leaf,
            "card_s": secs["card"], "cpu_s": secs["cpu"]}


# ---------------------------------------------------------------------------
# Field training
# ---------------------------------------------------------------------------


def lego_camera():
    """lego's intrinsics at 800x800 (blender's camera_angle_x) -> K."""
    focal = 0.5 * FT_WH / math.tan(0.5 * FT_CAMERA_ANGLE_X)
    return np.array([[focal, 0, FT_WH / 2], [0, focal, FT_WH / 2], [0, 0, 1]],
                    np.float32)


def _ray_grid(dev):
    """lego's camera (800x800, camera_angle_x 0.6911) -> (unit camera-frame
    directions [H*W, 3], mip radii [H*W, 1]) on ``dev``, as the Blender
    loader computes them (data/rays_np.py)."""
    unit, radii = ray_grids(FT_WH, FT_WH, lego_camera())
    return (torch.as_tensor(unit.reshape(-1, 3), device=dev),
            torch.as_tensor(radii.reshape(-1, 1), device=dev))


def synthetic_ray_pool(dev, n, seed, stacked=False):
    """``n`` synthetic 800x800 RGBA frames made on the card, as a Blender
    split: cameras on a sphere of radius 4 looking at the origin (the test
    fixture's rig), rays with mip radii, and a smooth colour pattern that
    changes with the view under the blob mask as alpha. -> a dataset
    namespace: flat ``all_rays`` [n*H*W, 7] and ``all_rgbs`` [n*H*W, 4],
    or stacked [n, H, W, C] with ``stacked``."""
    rng = np.random.default_rng(seed)
    dirs, radii = _ray_grid(dev)
    hw = FT_WH * FT_WH
    rays = torch.empty((n, hw, 7), device=dev)
    rgbs = torch.empty((n, hw, 4), device=dev)
    yy, xx = (torch.arange(FT_WH, device=dev, dtype=torch.float32) / FT_WH,) * 2
    pattern = torch.stack(torch.meshgrid(yy, xx, indexing="ij"), -1).reshape(-1, 2)
    alpha = blob_mask(FT_WH, FT_WH, dev).float().reshape(-1, 1)
    for k in range(n):
        theta = 2 * math.pi * (k + rng.random()) / n
        phi = math.radians(10 + 50 * rng.random())
        c2w = torch.as_tensor(_look_at_c2w(4.0 * np.array(
            [math.cos(theta) * math.cos(phi), math.sin(theta) * math.cos(phi),
             math.sin(phi)])), device=dev)
        rays[k, :, :3] = c2w[:3, 3]
        rays[k, :, 3:6] = dirs @ c2w[:3, :3].T
        rays[k, :, 6:] = radii
        rgbs[k, :, :3] = 0.5 + 0.4 * torch.sin(
            6.0 * pattern[:, :1] * torch.tensor([1.0, 2.0, 3.0], device=dev)
            + 4.0 * pattern[:, 1:] + theta)
        rgbs[k, :, 3:] = alpha
    shape = (n, FT_WH, FT_WH) if stacked else (n * hw,)
    return types.SimpleNamespace(
        all_rays=rays.reshape(shape + (7,)), all_rgbs=rgbs.reshape(shape + (4,)),
        white_bg=True, near_far=(2.0, 6.0), img_wh=(FT_WH, FT_WH),
        scene_bbox=np.array([[-1.5] * 3, [1.5] * 3], np.float32))


def config_args(name, iters, upsamples, mask_updates, ckpt=None, extra=()):
    """configs/<name>.txt through the port's parser, cut to ``iters``
    iterations with the upsamples and mask updates at the given ones, with
    the flags ``extra`` on the command line."""
    cmd = ["--config", str(Path(__file__).resolve().parent / "configs"
                           / f"{name}.txt"),
           "--n_iters", str(iters), "--N_vis", "0", "--ckpt_every", "0",
           "--progress_refresh_rate", str(iters), *extra]
    for it in upsamples:
        cmd += ["--upsamp_list", str(it)]
    for it in mask_updates:
        cmd += ["--update_AlphaMask_list", str(it)]
    if ckpt is not None:
        cmd += ["--ckpt", str(ckpt)]
    return config_parser(cmd)


def field_train_args(ckpt=None):
    """configs/lego.txt cut to FT_ITERS iterations with the upsamples and
    mask updates at FT_EVENTS."""
    return config_args("lego", FT_ITERS, FT_EVENTS, FT_EVENTS, ckpt)


@contextlib.contextmanager
def timed_field_steps():
    """Times the field trainer's steps while open (the loop looks the step
    up in its module each iteration) -> a list with, for each step, its
    host seconds up to a synchronize, its mse, grid, samples a ray and
    peak device memory."""
    steps = []
    step = field_trainer.train_step

    def timed(config, params, opt, *args, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mse = step(config, params, opt, *args, **kw)
        steps.append({"s": _sync_s(t0), "mse": float(mse),
                      "grid": list(config.grid_size),
                      "n_samples": kw["n_samples"],
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
        return mse

    field_trainer.train_step = timed
    try:
        yield steps
    finally:
        field_trainer.train_step = step


@contextlib.contextmanager
def captured_backwards(last_only=False):
    """Keeps a copy of the inputs of the first backward launch at each grid
    while open (of the last grid only with ``last_only``) -> {grid (h, w, l
    of pair 0): (params, xyz, dsigma, dapp)}."""
    out = {}
    launch = field_features_module._launch_backward

    def capture(tables, dims, flat, dsigma, dapp, wanted):
        key = tuple(dims[:3])
        if key not in out:
            if last_only:
                out.clear()
            params = {name: tuple(a.detach().clone()
                                  for a in tables[3 * j:3 * j + 3])
                      for j, name in enumerate(TABLES)}
            out[key] = (params, flat.clone(), dsigma.clone(),
                        None if dapp is None else dapp.clone())
        return launch(tables, dims, flat, dsigma, dapp, wanted)

    field_features_module._launch_backward = capture
    try:
        yield out
    finally:
        field_features_module._launch_backward = launch


def plain_backward_chunked(params, xyz, dsigma, dapp):
    """field_features_backward_plain summed over chunks of FT_PLAIN_CHUNK
    samples (a gradient is a sum over samples; one call at a step's 4
    million samples would hold tens of GB of corner rows)."""
    total = None
    for i in range(0, xyz.shape[0], FT_PLAIN_CHUNK):
        part = field_features_backward_plain(
            params, xyz[i:i + FT_PLAIN_CHUNK], dsigma[i:i + FT_PLAIN_CHUNK],
            None if dapp is None else dapp[i:i + FT_PLAIN_CHUNK])
        total = part if total is None else {
            k: tuple(a + b for a, b in zip(total[k], part[k])) for k in part}
    return total


def backward_errors(params, xyz, dsigma, dapp):
    """The backward kernel against its plain version -> the largest share
    of FIELD_GRAD_TOL x (leaf's largest |grad|) that a leaf's error takes,
    that leaf, and the largest abs error; raises beyond the tolerance."""
    got = field_features_backward(FieldConfig(), params, xyz, dsigma, dapp)
    torch.cuda.synchronize()
    want = plain_backward_chunked(params, xyz, dsigma, dapp)
    worst, leaf, err_max = 0.0, "", 0.0
    for name in want:
        for i, (a, b) in enumerate(zip(got[name], want[name])):
            err = float((a - b).abs().max())
            share = err / (FIELD_GRAD_TOL * max(float(b.abs().max()), 1e-30))
            err_max = max(err_max, err)
            if share >= worst:
                worst, leaf = share, f"{name}[{i}]"
    check(worst <= 1.0, f"field_features backward vs plain: {leaf} at "
          f"{worst} of its tolerance")
    return {"n": xyz.shape[0], "worst_share_of_tolerance": worst,
            "worst_leaf": leaf, "max_abs_err": err_max,
            "samples_with_grad": int((dsigma != 0).sum())}


def live_rows(params, xyz, dsigma, dapp):
    """For each axis pair and kind (density; appearance when ``dapp`` is
    given): (the plane and line rows that the samples with a nonzero
    upstream word touch, the kind's ranks, those samples) -> a list."""
    _, dims = kernel_layout(params, dapp is not None)
    live = {"density": dsigma != 0,
            "app": None if dapp is None else (dapp != 0).any(-1)}
    out = []
    for i in range(3):
        h, w, length, rd, ra = dims[5 * i:5 * i + 5]
        m0, m1 = MAT_MODE[i]
        for kind, ranks in (("density", rd), ("app", ra)):
            if live[kind] is None:
                continue
            pts = xyz[live[kind]]
            plane, valid2, _ = corners_2d(h, w, torch.stack(
                [pts[:, m0], pts[:, m1]], -1))
            line, valid1, _ = corners_1d(length, pts[:, VEC_MODE[i]])
            out.append((torch.unique(plane[valid2]).numel()
                        + torch.unique(line[valid1]).numel(), ranks,
                        pts.shape[0]))
    return out


def backward_bound(params, xyz, dsigma, dapp):
    """Bytes: the coordinates and upstream gradients read once, and each
    table row that a sample with a nonzero upstream word touches read once
    and its gradient row written once -> (ms, bound_by)."""
    n = xyz.shape[0]
    moved = n * 12 + n * 4 + (0 if dapp is None else dapp.numel() * 4)
    moved += sum(2 * rows * ranks * 4
                 for rows, ranks, _ in live_rows(params, xyz, dsigma, dapp))
    return bound(moved, 0.0, torch.float32)


def library_backward(params, xyz, dsigma, dapp):
    """The same gradients through F.grid_sample's backward (ATen's
    grid_sampler_2d backward), a timing yardstick -> a function that runs
    the backward once (the forward graph built once and kept)."""
    tables = library_tables(params)
    flat = [t.requires_grad_() for kind in ("density", "app")
            for pair in tables[kind] for t in pair]
    sigma, app = library_features(tables, xyz, True)

    def run():
        return torch.autograd.grad((sigma, app), flat, (dsigma, dapp),
                                   retain_graph=True)
    return run


def step_split_field(config, params, mask, pool, n_samples, dev, profile=True,
                     weights=None, **loss_kw):
    """Two more steps on the trained field: the second one with CUDA events
    after its forward, backward and Adam (the first builds Adam's state),
    then, with ``profile``, one under the profiler -> ms of each part and
    the profile. The loss is lego's (L1 4e-5 on, TV off) unless
    ``weights`` and ``loss_kw`` say otherwise; the background is the
    pool's."""
    p = trainable(params, dev)
    opt = field_trainer.make_optimizer(p, 0.02, 1e-3, 1.0)
    idx = torch.as_tensor(np.random.default_rng(SEED + 7).integers(
        0, pool.all_rays.shape[0], FT_BATCH), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bg = torch.full((3,), 1.0 if pool.white_bg else 0.0, device=dev)
    weights = weights or {"l1": 4e-5, "tv_d": 0.0, "tv_a": 0.0}
    kw = dict(dict(use_l1=True), **loss_kw, n_samples=n_samples, gen=gen)

    def step(mark=None):
        field_trainer.train_step(config, p, opt, mask, pool.all_rays[idx],
                                 pool.all_rgbs[idx], bg, weights, mark=mark,
                                 **kw)
    step()
    events = [("start", torch.cuda.Event(enable_timing=True))]
    events[0][1].record()

    def mark(label):
        events.append((label, torch.cuda.Event(enable_timing=True)))
        events[-1][1].record()

    step(mark)
    torch.cuda.synchronize()
    split = {f"{label}_ms": a.elapsed_time(b)
             for (_, a), (label, b) in zip(events, events[1:])}

    def one():
        step()
        return 1

    if profile:
        split["profile"] = _profiled("field_train_step", one)
    return split


def phase_field_train_small(pool, dev):
    """The reduced run on the card and on the CPU: a 32^3 lego-width field
    (Ref shading) with the cluster mask, 256 rays a step from the pool, 3
    steps with the upsample to 40^3 and Adam rebuilt before the third, the
    same initial parameters, indices and jitter on both -> the largest
    share of the tolerance a leaf takes (the ID-training rule of the CPU
    parity tests, rtol 1e-3 and atol max(5e-5, 0.1 lr), at each group's
    rate), and the run's seconds on each device."""
    args = field_train_args()
    config = field_config_from_args(args, [[-1.5] * 3, [1.5] * 3],
                                    (FT_SMALL_GRID,) * 3, (2.0, 6.0))
    init = init_field(torch.Generator().manual_seed(SEED), config)
    vol = cluster_volume(FT_SMALL_GRID, 1.75, torch.device("cpu")).float()
    rng = np.random.default_rng(SEED + 11)
    rows = torch.as_tensor(rng.integers(0, pool.all_rays.shape[0],
                                        (FT_SMALL_STEPS, FT_SMALL_BATCH)))
    rays = pool.all_rays[rows.to(dev)].cpu()
    rgbs = pool.all_rgbs[rows.to(dev)].cpu()
    jitter = torch.as_tensor(rng.random((FT_SMALL_STEPS, FT_SMALL_BATCH, 1),
                                        dtype=np.float32))
    lr_factor = args.lr_decay_target_ratio ** (1.0 / 30000)
    out, secs = {}, {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        cfg = config
        p = trainable(init, device)
        mask = make_alpha_mask(vol.to(device), cfg.aabb_np)
        opt = field_trainer.make_optimizer(p, args.lr_init, args.lr_basis,
                                           lr_factor)
        for k in range(FT_SMALL_STEPS):
            if k == FT_SMALL_STEPS - 1:
                with torch.no_grad():
                    cfg, p = upsample_volume_grid(cfg, p, (FT_SMALL_UP,) * 3)
                p = trainable(p, device)
                opt = field_trainer.make_optimizer(p, args.lr_init,
                                                   args.lr_basis, lr_factor)
            field_trainer.train_step(
                cfg, p, opt, mask, rays[k].to(device), rgbs[k].to(device),
                torch.ones(3, device=device),
                {"l1": args.L1_weight_inital, "tv_d": 0.0, "tv_a": 0.0},
                n_samples=cal_n_samples(cfg.grid_size, args.step_ratio),
                jitter=jitter[k].to(device), use_l1=True)
        out[name] = p
        secs[name] = _sync_s(t0)
    ref, new = (_flatten(_numpy_leaves(out[k])) for k in ("cpu", "card"))
    worst = (0.0, "")
    for name, a in ref.items():
        lr = (args.lr_basis if name.split("/")[0] in field_trainer.NETWORK
              else args.lr_init)
        diff = np.abs(new[name] - a)
        share = float((diff / (max(5e-5, 0.1 * lr) + 1e-3 * np.abs(a))).max())
        worst = max(worst, (share, name))
    check(worst[0] <= 1.0, f"card and CPU field parameters agree after "
          f"{FT_SMALL_STEPS} steps (worst share {worst[0]}, {worst[1]})")
    return {"grid": FT_SMALL_GRID, "upsampled_to": FT_SMALL_UP,
            "batch": FT_SMALL_BATCH, "steps": FT_SMALL_STEPS,
            "worst_share_of_tolerance": worst[0], "worst_leaf": worst[1],
            "card_s": secs["card"], "cpu_s": secs["cpu"]}


def estimate_full_run(steps, events, aabb):
    """A 30 000-iteration lego run from this run's numbers: the step time
    at each grid of lego's schedule (five upsamples at 2000, 3000, 4000,
    5500 and 7000; mask updates at 2000 and 4000) from a line through the
    two measured medians in samples a ray, times its steps, plus two mask
    updates and five upsamples at this run's mean event times."""
    args = field_train_args()
    first = [st for st in steps if st["grid"] == steps[0]["grid"]][1:]
    last = [st for st in steps if st["grid"] == steps[-1]["grid"]][1:]
    (n0, t0), (n1, t1) = ((st[0]["n_samples"],
                           statistics.median(x["s"] for x in st))
                          for st in (first, last))
    slope = (t1 - t0) / max(n1 - n0, 1)
    bounds = [0, 2000, 3000, 4000, 5500, 7000, 30000]
    grids = [N_to_reso(args.N_voxel_init, [[-1.5] * 3, [1.5] * 3])] + [
        N_to_reso(n, aabb) for n in n_voxel_schedule(
            args.N_voxel_init, args.N_voxel_final, 5)]
    total, per_grid = 0.0, []
    for (a, b), grid in zip(zip(bounds, bounds[1:]), grids):
        ns = cal_n_samples(grid, args.step_ratio)
        t = t0 + slope * (ns - n0)
        per_grid.append({"iters": b - a, "grid": grid, "n_samples": ns,
                         "step_s": t})
        total += (b - a) * t
    masks = [e["s"] for e in events if e["event"].startswith("alpha")]
    ups = [e["s"] for e in events if e["event"] == "upsample"]
    events_s = 2 * statistics.mean(masks) + 5 * statistics.mean(ups)
    return {"steps_s": total, "events_s": events_s,
            "total_s": total + events_s, "per_grid": per_grid}


def train_with_capture(dev):
    """TensoRF training through ``train_field`` (reconstruction's loop) at
    configs/lego.txt's widths: from a 128^3 field whose density follows
    the fixture's cluster (the alpha mask of its checkpoint, 8 % of the
    AABB), on a pool of 100 synthetic 800x800 frames made on the card
    (lego's train split, 64 M rays), batch 4 096, cut to FT_ITERS
    iterations with the mask update and shrink, an upsample, the mask
    update with ray filtering and the upsample to 300^3 at FT_EVENTS.
    Launch counts set to 0 just before the run and read just after it;
    each step timed, the inputs of the first backward at each grid kept.
    -> a namespace: args, the trained config, params and mask, the pools,
    the steps, events, counts, torch lerps, the kept backward inputs
    (``caught``) and the run's and the pool's seconds."""
    WORK_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    pool = synthetic_ray_pool(dev, FT_POOL, SEED + 20)
    test = synthetic_ray_pool(dev, 1, SEED + 21, stacked=True)
    pool_s = _sync_s(t0)
    args = field_train_args(WORK_DIR / "lego_field_128.npz")
    cfg0, np_params, mask0 = make_lego_field(dev, FT_GRID_INIT, spread=1.75)
    config = field_config_from_args(args, pool.scene_bbox,
                                    (FT_GRID_INIT,) * 3, pool.near_far)
    widths = ("grid_size", "density_n_comp", "app_n_comp", "app_dim",
              "shading_mode", "feature_c", "view_pe", "fea_pe", "aabb")
    check(all(getattr(cfg0, k) == getattr(config, k) for k in widths),
          "the 128^3 field has configs/lego.txt's widths")
    save_field(args.ckpt, config, np_params, mask0)
    del np_params, mask0
    config, params, mask = load_field(args.ckpt, device=dev)
    events = []
    torch.cuda.synchronize()
    with timed_field_steps() as steps, captured_backwards() as caught, \
            count_torch_lerps() as torch_lerps:
        _reset_counts()
        t0 = time.perf_counter()
        config, params, mask = train_field(
            args, config, params, mask, pool, test,
            str(WORK_DIR / "field_train"), log_fn=lambda *a: None,
            device=dev, events=events,
            reso_cur=N_to_reso(args.N_voxel_init, pool.scene_bbox))
        run_s = _sync_s(t0)
        counts = _counts()
    return types.SimpleNamespace(
        args=args, config=config, params=params, mask=mask, pool=pool,
        test=test, steps=steps, events=events, counts=counts,
        torch_lerps=torch_lerps["n"], caught=caught, run_s=run_s,
        pool_s=pool_s)


def axis_ray_inputs(params, dev):
    """The backward's inputs on axis-aligned rays, where consecutive
    samples add into the same rows longest: FT_AXIS_RAYS rays along +-x,
    +-y and +-z in turn, FT_AXIS_PER_RAY samples each half a texel apart
    (beyond [-1, 1] at both ends), the upstream normal with stretches of
    zeros (``tools/ff_time.py``'s ``ray_ordered_samples`` and
    ``ray_upstream``) -> (params, xyz, dsigma, dapp) as captured_backwards
    keeps them."""
    grid = tuple(params["density_plane"][0].shape[1::-1]) + (
        params["density_line"][0].shape[0],)
    xyz = np.concatenate([
        ray_ordered_samples(grid, AXES, FT_AXIS_PER_RAY, SEED + 30 + k)
        for k in range(FT_AXIS_RAYS // len(AXES))])
    width = sum(a.shape[-1] for a in params["app_plane"])
    dsigma, dapp = ray_upstream(xyz.shape[0], width, SEED + 31)
    return (params, *(torch.as_tensor(a, device=dev)
                      for a in (xyz, dsigma, dapp)))


def plain_features_chunked(params, xyz):
    """field_features_plain on plain gathers, over chunks of FT_PLAIN_CHUNK
    samples (one call at a step's 4 million samples would hold about 13 GB
    of corner rows)."""
    with plain_gathers():
        return [field_features_plain(params, xyz[i:i + FT_PLAIN_CHUNK], True)
                for i in range(0, xyz.shape[0], FT_PLAIN_CHUNK)]


def forward_errors(params, xyz, want=None):
    """field_features (with appearance) against its plain version's
    (sigma, app), ``want`` or else ``plain_features_chunked``, at a
    training step's samples: app products bit-equal, sigma within
    FIELD_RTOL and FIELD_ATOL x max|plain| (raises otherwise) -> the
    errors."""
    with torch.no_grad():
        sigma, app = field_features(FieldConfig(), params, xyz, True)
        torch.cuda.synchronize()
        if want is None:
            chunks = plain_features_chunked(params, xyz)
            want = (torch.cat([c[0] for c in chunks]),
                    torch.cat([c[1] for c in chunks]))
            del chunks
        scale = float(want[0].abs().max())
        out = {"n": xyz.shape[0], "app_bit_equal": bool(torch.equal(app, want[1])),
               "app_max_abs_err": float((app - want[1]).abs().max()),
               "sigma_max_abs_err": float((sigma - want[0]).abs().max()),
               "sigma_max_abs_plain": scale}
        check(out["app_bit_equal"] and torch.allclose(
            sigma, want[0], rtol=FIELD_RTOL, atol=FIELD_ATOL * scale),
            f"field_features vs plain at a step's samples: {out}")
    del sigma, app, want
    torch.cuda.empty_cache()
    return out


def forward_row(params, xyz):
    """field_features (forward) at a training step's samples: graph and
    eager ms, its bound (bytes), the plain version's ms (chunked) and
    F.grid_sample's, after checking that both compute the same."""
    config = FieldConfig()
    with torch.no_grad():
        ours = field_features(config, params, xyz, True)
        tables = library_tables(params)
        lib = library_features(tables, xyz, True)
        diff = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(ours, lib))
        check(diff < 1e-5, f"F.grid_sample yardstick at the step ({diff})")
        del ours, lib
        b_ms, b_by, corner_bytes = field_bound(params, xyz, True)
        row = {"n": xyz.shape[0],
               "ms": time_ms(lambda: field_features(config, params, xyz, True),
                             reps=FT_REPS, graph=True),
               "eager_ms": time_ms(lambda: field_features(config, params, xyz,
                                                          True), reps=FT_REPS),
               "plain_ms": time_ms(lambda: plain_features_chunked(params, xyz),
                                   reps=3),
               "library_ms": time_ms(lambda: library_features(tables, xyz, True),
                                     reps=FT_REPS),
               "bound_ms": b_ms, "bound_by": b_by,
               "corner_read_bytes": corner_bytes, "library_max_rel_diff": diff}
    torch.cuda.empty_cache()
    return row


def steps_by_grid(steps):
    """The timed steps by grid -> {"HxWxL": the median, range and first
    seconds of its steps (the first left out of the median and range when
    there are more), samples a ray and a batch, the peak memory}."""
    by_grid = {}
    for st in steps:
        by_grid.setdefault(tuple(st["grid"]), []).append(st)
    out = {}
    for grid, grid_steps in by_grid.items():
        xs = [st["s"] for st in grid_steps[1:]] or [grid_steps[0]["s"]]
        out["x".join(map(str, grid))] = {
            "median_s": statistics.median(xs), "range_s": [min(xs), max(xs)],
            "first_s": grid_steps[0]["s"], "steps": len(grid_steps),
            "n_samples": grid_steps[0]["n_samples"],
            "rays_samples": FT_BATCH * grid_steps[0]["n_samples"],
            "peak_mem_gb": max(st["peak_mem_gb"] for st in grid_steps)}
    return out


def backward_row(p, xyz, dsigma, dapp):
    """field_features' backward at a training step's inputs: eager and
    graph ms, its bound (bytes), the plain version's ms (chunked) and
    F.grid_sample's backward's."""
    b_ms, b_by = backward_bound(p, xyz, dsigma, dapp)
    lib = library_backward(p, xyz, dsigma, dapp)
    row = {"n": xyz.shape[0],
           "ms": time_ms(lambda: field_features_backward(
               FieldConfig(), p, xyz, dsigma, dapp), reps=FT_REPS),
           "graph_ms": time_ms(lambda: field_features_backward(
               FieldConfig(), p, xyz, dsigma, dapp), reps=FT_REPS, graph=True),
           "plain_ms": time_ms(lambda: plain_backward_chunked(
               p, xyz, dsigma, dapp), reps=3),
           "library_ms": time_ms(lib, reps=FT_REPS),
           "bound_ms": b_ms, "bound_by": b_by}
    del lib
    torch.cuda.empty_cache()
    return row


def phase_field_train(dev):
    """``train_with_capture``, its checks, and the forward and backward
    kernels held to their plain versions on the kept inputs at 128^3 and
    at the final grid, and on ``axis_ray_inputs`` at the final grid; both
    kernels' ms at both steps and on the axis-aligned rays, the forward's
    row at the final step's samples. Then the split and profile of a step,
    one 800x800 eval render (seconds, PSNR, SSIM), the reduced card-vs-CPU
    run, and the estimate of a 30 000-iteration run. -> (the run's launch
    counts, the kernels line's entry for the backward, the forward's row at
    the final step with its checks)."""
    run = train_with_capture(dev)
    args, config, params, mask = run.args, run.config, run.params, run.mask
    pool, test, steps, events, counts = (run.pool, run.test, run.steps,
                                         run.events, run.counts)
    run_s, pool_s = run.run_s, run.pool_s
    check(len(steps) == FT_ITERS, f"{len(steps)} steps")
    check(counts["field_features"] > 0 and counts["field_features_backward"]
          == FT_ITERS and counts["gather_rows"] > 0,
          f"the run launched field_features, its backward and K3: {counts}")
    check(run.torch_lerps == 0, f"{run.torch_lerps} texel lerps in torch")
    check(counts["banked_scores"] == 0 and counts["fused_ray_scores"] == 0,
          f"field training runs no scoring kernel: {counts}")
    kinds = [e["event"] for e in events]
    check(kinds == ["alpha-mask update + shrink", "upsample",
                    "alpha-mask update + ray filtering", "upsample"],
          f"the phase events {kinds}")
    grid = tuple(config.grid_size)
    check(math.prod(grid) > 0.9 * args.N_voxel_final, f"final grid {grid}")
    mses = [st["mse"] for st in steps]
    check(all(math.isfinite(x) for x in mses), f"finite losses {mses}")
    check(all(a != b for a, b in zip(mses, mses[1:])),
          f"the loss changes from step to step {mses}")
    check(all(bool(torch.isfinite(a).all()) for a in leaves(params)),
          "finite trained parameters")

    caught = run.caught
    keys = list(caught)
    check(len(keys) == 3, f"backward inputs of three grids: {keys}")
    cases = {"grid_128": caught[keys[0]], "grid_final": caught[keys[-1]]}
    del caught, run
    cases["axis_rays"] = axis_ray_inputs(cases["grid_final"][0], dev)
    bwd_checks, fwd_checks = {}, {}
    for label, (p, xyz, dsigma, dapp) in cases.items():
        fwd_checks[label] = forward_errors(p, xyz)
        with torch.no_grad():
            for key, graph in (("ms", True), ("eager_ms", False)):
                fwd_checks[label][key] = time_ms(lambda: field_features(
                    FieldConfig(), p, xyz, True), reps=FT_REPS, graph=graph)
        bwd_checks[label] = backward_errors(p, xyz, dsigma, dapp)
        bwd_checks[label]["grid"] = list(p["density_plane"][0].shape[1::-1]) + [
            p["density_line"][0].shape[0]]
        bwd_checks[label]["ms"] = time_ms(lambda: field_features_backward(
            FieldConfig(), p, xyz, dsigma, dapp), reps=FT_REPS)
    p, xyz, dsigma, dapp = cases.pop("grid_final")
    del cases
    row = backward_row(p, xyz, dsigma, dapp)
    del dsigma, dapp
    torch.cuda.empty_cache()
    fwd_row = forward_row(p, xyz)
    del p, xyz
    torch.cuda.empty_cache()

    n_final = cal_n_samples(config.grid_size, args.step_ratio)
    split = step_split_field(config, params, mask, pool, n_final, dev)
    log = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    psnr = evaluation(test, config, params, mask, None, N_vis=-1,
                      n_samples=n_final, white_bg=True, device=dev, log=log)
    eval_s = _sync_s(t0)
    eval_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(len(psnr) == 1 and math.isfinite(psnr[0]), f"eval PSNR {psnr}")
    small = phase_field_train_small(pool, dev)
    full = estimate_full_run(steps, events, np.asarray(config.aabb))

    emit(phase="field_train", iters=FT_ITERS, events_at=FT_EVENTS,
         batch=FT_BATCH, pool_rays=FT_POOL * FT_WH * FT_WH, pool_s=pool_s,
         final_grid=list(grid), final_aabb=[list(a) for a in config.aabb],
         run_s=run_s, step_s=[st["s"] for st in steps], mse=mses,
         steps_by_grid=steps_by_grid(steps),
         phase_events=events, split=split,
         peak_mem_gb=max(st["peak_mem_gb"] for st in steps),
         launches=counts, backward_checks=bwd_checks,
         backward_tolerance=FIELD_GRAD_TOL, forward_checks=fwd_checks,
         forward_at_step=fwd_row,
         eval_render={
             "s": eval_s, "psnr": psnr[0], "ssim": log["ssim"][0],
             "n_samples": n_final, "peak_mem_gb": eval_peak},
         card_vs_cpu=small, run_of_30000=full)
    entry = dict(
        name="field_features_backward", route="cuda",
        source="iffnerf_tpu_torch/csrc/field_features.cu",
        replaces="iffnerf_tpu/ops/packed_sample.py:234",
        replaces_kind="the XLA custom VJPs of the packed gathers"
                      " (_gather_contract_bwd, _lerp_contract_mm_bwd); no"
                      " pallas_call differentiates this work",
        design="a group of lanes (a word of one axis pair each) walks a run"
               " of consecutive samples, keeps its corner rows' words and"
               " running sums in registers and adds a sum (one float4 RED)"
               " only when its row leaves the footprint or the run ends;"
               " zero-upstream samples skipped by a warp vote; xyz, dsigma"
               " and dapp bulk-copied into a 4-stage mbarrier ring by a"
               " producer warp",
        launches=counts["field_features_backward"],
        launches_by_path={"field_train": counts["field_features_backward"]},
        max_abs_err=bwd_checks["grid_final"]["max_abs_err"],
        ms_grid_128=bwd_checks["grid_128"]["ms"],
        ms_axis_rays=bwd_checks["axis_rays"]["ms"], **row)
    fwd = dict(fwd_row, checks=fwd_checks)
    return counts, entry, fwd


# ---------------------------------------------------------------------------
# iNeRF refinement
# ---------------------------------------------------------------------------


def make_inerf_field(dev):
    """The lego-width field of ``make_lego_field`` (300^3, ranks 16/48,
    Ref shading, the cluster mask) at step_ratio 0.5, with low-frequency
    appearance: its appearance factors drawn (mean 0, std INERF_APP_STD)
    on an INERF_COARSE^3 grid and upsampled to 300^3 by
    ``upsample_volume_grid``, so that the colour changes over tens of
    texels, as a trained field's does, and a photometric loss has a basin
    wider than the texel of per-texel noise. -> (config, params, mask)."""
    cfg, np_params, mask = make_lego_field(dev, GRID)
    params = params_from_numpy(np_params, device=dev)
    rng = np.random.default_rng(SEED + 40)

    def coarse_normal(shape):
        return torch.as_tensor(INERF_APP_STD * rng.standard_normal(
            shape, dtype=np.float32), device=dev)

    c = INERF_COARSE
    coarse = {}
    for kind, comps in (("density", cfg.density_n_comp),
                        ("app", cfg.app_n_comp)):
        coarse[f"{kind}_plane"] = tuple(coarse_normal((c, c, comps[i]))
                                        for i in range(3))
        coarse[f"{kind}_line"] = tuple(coarse_normal((c, comps[i]))
                                       for i in range(3))
    _, smooth = upsample_volume_grid(cfg.replace(grid_size=(c,) * 3), coarse,
                                     (GRID,) * 3)
    for name in ("app_plane", "app_line"):
        params[name] = tuple(a.contiguous() for a in smooth[name])
    return cfg.replace(step_ratio=INERF_STEP_RATIO), params, mask


def render_rgba(config, params, mask, c2w, cam_k, dev):
    """An 800x800 RGBA frame of the field at ``c2w`` (no grad, chunks of
    2^22 samples): the colour rendered over black divided by its opacity
    (straight colour, as an RGBA image stores it) and the opacity as alpha
    -> [800, 800, 4]."""
    dirs, radii = (torch.as_tensor(a.reshape(-1, a.shape[-1]), device=dev)
                   for a in ray_grids(FT_WH, FT_WH, cam_k))
    pose = torch.as_tensor(c2w, device=dev)
    rays_d = dirs @ pose[:3, :3].T
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rays = torch.cat([pose[:3, 3].expand(rays_d.shape), rays_d, radii], -1)
    chunk = (1 << 22) // config.n_samples
    black = torch.zeros(3, device=dev)
    out = []
    with torch.no_grad():
        for i in range(0, rays.shape[0], chunk):
            rgb, _, acc, _, _, _ = render_rays(config, params, mask,
                                               rays[i:i + chunk],
                                               is_train=False, bg_color=black)
            straight = torch.where(acc[:, None] > 1e-6,
                                   rgb / acc.clamp_min(1e-6)[:, None], 0.0)
            out.append(torch.cat([straight.clamp(0.0, 1.0), acc[:, None]], -1))
    return torch.cat(out).reshape(FT_WH, FT_WH, 4)


def perturbed(c2w):
    """The JAX test's start: 12 degrees about z, then +0.15 on each
    coordinate of the position (tests/test_pose_pipeline.py:163-170)."""
    ang = math.radians(INERF_ROT_DEG)
    rot = np.eye(4, dtype=np.float32)
    cos, sin = math.cos(ang), math.sin(ang)
    rot[:2, :2] = [[cos, -sin], [sin, cos]]
    start = rot @ c2w
    start[:3, 3] += INERF_SHIFT
    return start.astype(np.float32)


def pose_errors(gt, pose):
    """(translation error, angular error in degrees) of ``pose`` [..., 4,
    4] against ``gt``, with the port's pose.geometry."""
    gt, pose = (torch.as_tensor(np.asarray(a), dtype=torch.float64)
                for a in (gt, pose))
    return (float(compute_translation_error(gt[:3, 3], pose[:3, 3])),
            float(compute_angular_error(gt[:3, :3], pose[:3, :3])))


@contextlib.contextmanager
def kept_refine():
    """Keeps the output of the iNeRF loop while open (estimate_pose_inerf
    looks ``refine`` up in its module) -> {"out": (losses, pose, poses)}."""
    kept = {}
    refine = inerf_estimate.refine

    def keep(*args, **kw):
        kept["out"] = refine(*args, **kw)
        return kept["out"]

    inerf_estimate.refine = keep
    try:
        yield kept
    finally:
        inerf_estimate.refine = refine


@contextlib.contextmanager
def captured_coords_grad():
    """Keeps a copy of the inputs of the first coordinate-kernel launch
    while open -> {"inputs": (params, xyz, dsigma, dapp)}."""
    out = {}
    launch = field_features_module._launch_coords_grad

    def capture(tables, dims, flat, dsigma, dapp):
        if not out:
            params = {name: tuple(tables[3 * j:3 * j + 3])
                      for j, name in enumerate(TABLES)}
            out["inputs"] = (params, flat.clone(), dsigma.clone(),
                             None if dapp is None else dapp.clone())
        return launch(tables, dims, flat, dsigma, dapp)

    field_features_module._launch_coords_grad = capture
    try:
        yield out
    finally:
        field_features_module._launch_coords_grad = launch


def plain_coords_grad_chunked(params, xyz, dsigma, dapp):
    """field_features_coords_grad_plain over chunks of FT_PLAIN_CHUNK
    samples (each sample's gradient is its own)."""
    return torch.cat([field_features_coords_grad_plain(
        params, xyz[i:i + FT_PLAIN_CHUNK], dsigma[i:i + FT_PLAIN_CHUNK],
        None if dapp is None else dapp[i:i + FT_PLAIN_CHUNK])
        for i in range(0, xyz.shape[0], FT_PLAIN_CHUNK)])


def coords_grad_errors(params, xyz, dsigma, dapp):
    """The coordinate kernel against its plain version: within
    COORDS_GRAD_TOL of the largest |dxyz| (raises otherwise), a sample
    without upstream exactly 0 -> the errors."""
    got = field_features_coords_grad(FieldConfig(), params, xyz, dsigma, dapp)
    torch.cuda.synchronize()
    want = plain_coords_grad_chunked(params, xyz, dsigma, dapp)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    live = dsigma != 0
    if dapp is not None:
        live = live | (dapp != 0).any(-1)
    out = {"n": xyz.shape[0], "max_abs_err": err, "max_abs_plain": scale,
           "share_of_tolerance": err / (COORDS_GRAD_TOL * max(scale, 1e-30)),
           "samples_with_upstream": int(live.sum())}
    check(out["share_of_tolerance"] <= 1.0,
          f"coordinate kernel vs plain: {out}")
    check(not bool(got[~live].any()), "no upstream, no coordinate gradient")
    return out


def coords_grad_bound(params, xyz, dsigma, dapp):
    """Bytes: xyz, dsigma and dapp read once, dxyz written once, and each
    table row that a sample with a nonzero upstream touches read once;
    operations: about 40 float32 operations a rank of each such sample
    (six flag products, four lerps, the three derivative sums) -> (ms,
    bound_by)."""
    n = xyz.shape[0]
    moved = n * 12 + n * 4 + (0 if dapp is None else dapp.numel() * 4) + n * 12
    rows = live_rows(params, xyz, dsigma, dapp)
    moved += sum(r * ranks * 4 for r, ranks, _ in rows)
    ops = sum(40 * n_live * ranks for _, ranks, n_live in rows)
    return bound(moved, ops, torch.float32)


def library_coords_backward(params, xyz, dsigma, dapp):
    """The same gradient through F.grid_sample's backward with respect to
    the grid (the six lookups, tables frozen), a timing yardstick -> a
    function that runs the backward once (the forward graph built once and
    kept), after checking that it computes the same within
    COORDS_GRAD_TOL."""
    tables = library_tables(params)
    coords = xyz.detach().requires_grad_()
    sigma, app = library_features(tables, coords, True)

    def run():
        return torch.autograd.grad((sigma, app), coords, (dsigma, dapp),
                                   retain_graph=True)[0]

    want = plain_coords_grad_chunked(params, xyz, dsigma, dapp)
    diff = float((run() - want).abs().max() / want.abs().max())
    check(diff <= COORDS_GRAD_TOL, f"F.grid_sample backward yardstick "
          f"computes the same ({diff})")
    return run, diff


def inerf_scene(dev):
    """The refinement's set-up (``make_inerf_field``): the field, an
    800x800 frame rendered from it at a pose looking at the object, the
    JAX test's perturbation of that pose and the loop's inputs ->
    namespace (config, params, mask, cam_k, gt, obs, start, obs_t, cand,
    dirs, radii, start_t, coverage, target_s)."""
    t0 = time.perf_counter()
    config, params, mask = make_inerf_field(dev)
    cam_k = lego_camera()
    gt = _look_at_c2w(4.0 * np.array([math.cos(0.6) * math.cos(0.5),
                                      math.sin(0.6) * math.cos(0.5),
                                      math.sin(0.5)]))
    obs = render_rgba(config, params, mask, gt, cam_k, dev)
    target_s = _sync_s(t0)
    check(bool(torch.isfinite(obs).all()), "finite target frame")
    coverage = float((obs[..., 3] > 0.5).float().mean())
    check(0.05 < coverage < 0.95, f"the object covers part of the frame "
          f"({coverage})")
    start = perturbed(gt)
    obs_t, cand, dirs, radii = loop_inputs(obs, cam_k, dev)
    return types.SimpleNamespace(
        config=config, params=params, mask=mask, cam_k=cam_k, gt=gt, obs=obs,
        start=start, obs_t=obs_t, cand=cand, dirs=dirs, radii=radii,
        start_t=torch.as_tensor(start, device=dev), coverage=coverage,
        target_s=target_s)


def inerf_pose_grad(sc, cfg, p, idx, colour):
    """One iteration's (w, v, theta) gradient at the pose ``p`` off the
    start, for the draws (idx, colour), through ``cfg``'s route."""
    leaf = p.clone().requires_grad_()
    total, _ = inerf_estimate._loss(cfg, sc.params, sc.mask, leaf, sc.start_t,
                                    sc.obs_t, sc.dirs, sc.radii, sc.cand[idx],
                                    colour, True)
    return torch.autograd.grad(total, leaf)[0]


def captured_iteration(sc, dev):
    """One iteration's pose gradient through the kernels at a pose 0.05
    from the start, on the first draws of the seed, with the inputs of its
    coordinate-kernel launch kept -> (gradient, (p, idx, colour), the
    kernel's (params, xyz, dsigma, dapp))."""
    p = torch.as_tensor((0.05 * np.random.default_rng(SEED + 41)
                         .standard_normal(7)).astype(np.float32), device=dev)
    idx, colour = GeneratorDraws(SEED, sc.cand.shape[0], INERF_BATCH,
                                 dev).step(0)
    with captured_coords_grad() as caught:
        grad = inerf_pose_grad(sc, sc.config, p, idx, colour)
    return grad, (p, idx, colour), caught["inputs"]


def all_live_coords_inputs(params, dev):
    """The coordinate kernel's all-live input at ``params``' grid:
    INERF_LIVE_RAYS rays in random directions of INERF_LIVE_PER_RAY samples
    half a texel apart (``ray_ordered_samples``), every upstream word
    normal (numpy, from the seed) -> (params, xyz, dsigma, dapp)."""
    grid = tuple(params["density_plane"][0].shape[1::-1]) + (
        params["density_line"][0].shape[0],)
    dirs = np.random.default_rng(SEED + 46).standard_normal(
        (INERF_LIVE_RAYS, 3))
    xyz = ray_ordered_samples(grid, dirs, INERF_LIVE_PER_RAY, SEED + 47,
                              spread=INERF_LIVE_SPREAD)
    rng = np.random.default_rng(SEED + 48)
    n = xyz.shape[0]
    width = sum(a.shape[-1] for a in params["app_plane"])
    dsigma = rng.standard_normal(n, dtype=np.float32)
    dapp = rng.standard_normal((n, width), dtype=np.float32)
    return (params, *(torch.as_tensor(a, device=dev)
                      for a in (xyz, dsigma, dapp)))


def coords_grad_repeats(params, xyz, dsigma, dapp, calls=3):
    """Whether ``calls`` launches of the coordinate kernel on the same
    inputs give bit-equal gradients."""
    first = field_features_coords_grad(FieldConfig(), params, xyz, dsigma,
                                       dapp)
    return all(torch.equal(first, field_features_coords_grad(
        FieldConfig(), params, xyz, dsigma, dapp)) for _ in range(calls - 1))


def phase_inerf(id_params, id_cfg, rays, dev):
    """iNeRF refinement at lego's width (``make_inerf_field``): the
    coordinate kernel held to its plain version at one iteration's
    samples and upstream, on an all-live ray-ordered set, random,
    texel-boundary and axis-aligned points and on non-cubic fields (4-byte
    words too), bit-equal across repeats at the iteration and the all-live
    set, and timed at both beside its bound, its plain version and
    F.grid_sample's backward; one
    iteration's pose gradient through the kernels against the all-plain
    route, and 10 iterations of both on the same draws; then the main
    path: ``estimate_pose_inerf`` at test_pose_estimation's settings from
    the JAX test's perturbation of an 800x800 frame rendered from the
    field (launch counts set to 0 just before and read just after; the
    errors before and after, the loss, host and CUDA-event ms, a profiled
    stretch of iterations, peak memory); and ``test_pose_estimation`` with
    ``inerf_refinement`` on that frame. -> (the main path's launch counts,
    the kernels line's entry for the coordinate kernel)."""
    sc = inerf_scene(dev)
    config, params, mask = sc.config, sc.params, sc.mask
    cam_k, gt, obs, start = sc.cam_k, sc.gt, sc.obs, sc.start
    obs_t, cand, dirs, radii = sc.obs_t, sc.cand, sc.dirs, sc.radii
    start_t, n_cand = sc.start_t, sc.cand.shape[0]

    # one iteration's pose gradient: both kernels against the all-plain
    # route, at a pose 0.05 from the start; the kernel's inputs kept
    g_kernel, (p, idx, colour), it_inputs = captured_iteration(sc, dev)
    plain_cfg = config.replace(fused_eval="off")
    with plain_gathers():
        g_plain = inerf_pose_grad(sc, plain_cfg, p, idx, colour)
    grad_share = float((g_kernel - g_plain).abs().max()) / (
        POSE_GRAD_TOL * float(g_plain.abs().max()))
    check(grad_share <= 1.0, f"pose gradient, kernels vs all-plain route: "
          f"{g_kernel.tolist()} vs {g_plain.tolist()}")

    def run_refine(cfg, n_iters, seed=SEED):
        return inerf_estimate.refine(
            cfg, params, mask, start_t, obs_t, cand, dirs, radii,
            GeneratorDraws(seed, n_cand, INERF_BATCH, dev), lrate=INERF_LRATE,
            n_iters=n_iters, color_bkgd_aug="random", dice_loss=True)

    k_losses, _, k_poses = run_refine(config, INERF_ROUTE_ITERS)
    with plain_gathers():
        p_losses, _, p_poses = run_refine(plain_cfg, INERF_ROUTE_ITERS)
    route_pose_diff = float((k_poses - p_poses).abs().max())
    check(route_pose_diff <= POSE_ROUTE_ATOL, f"{INERF_ROUTE_ITERS} "
          f"iterations, kernels vs all-plain route: poses {route_pose_diff}")
    routes = {"grad_kernels": g_kernel.tolist(),
              "grad_plain": g_plain.tolist(),
              "grad_share_of_tolerance": grad_share,
              "pose_max_abs_diff_after_10": route_pose_diff,
              "loss_max_rel_diff_10": float(((k_losses - p_losses).abs()
                                             / p_losses.abs()).max())}

    # the coordinate kernel against its plain version, and its times
    g = torch.Generator(device=dev).manual_seed(SEED + 42)
    it_params, it_xyz, it_dsigma, it_dapp = it_inputs
    width = it_dapp.shape[1]

    def upstream(n, seed):
        return tuple(torch.as_tensor(a, device=dev)
                     for a in ray_upstream(n, width, seed))

    texels = (torch.randint(0, GRID, (10 ** 5, 3), generator=g, device=dev)
              .float() * (2.0 / (GRID - 1)) - 1.0)
    cases = {"iteration": it_inputs,
             "all_live": all_live_coords_inputs(params, dev),
             "uniform_1e6": (params, random_coords(10 ** 6, 1.2, g, dev),
                             *upstream(10 ** 6, SEED + 43)),
             "texel_boundaries": (params, texels,
                                  *upstream(10 ** 5, SEED + 44)),
             "axis_rays": axis_ray_inputs(params, dev)}
    for name, (grid, rd, ra) in NON_CUBIC.items():
        _, nc = random_vm_field(grid, rd, ra, g, dev)
        n = 10 ** 5
        ds, da = (torch.as_tensor(a, device=dev)
                  for a in ray_upstream(n, sum(ra), SEED + 45))
        cases[name] = (nc, random_coords(n, 1.1, g, dev), ds, da)
    kernel_checks = {name: coords_grad_errors(*case)
                     for name, case in cases.items()}
    for name in ("iteration", "all_live"):
        kernel_checks[name]["repeats_bit_equal"] = coords_grad_repeats(
            *cases[name])
        check(kernel_checks[name]["repeats_bit_equal"],
              f"coordinate kernel repeats bit-equal at {name}")
    live_case = cases["all_live"]
    del cases
    b_ms, b_by = coords_grad_bound(it_params, it_xyz, it_dsigma, it_dapp)
    lib, lib_diff = library_coords_backward(it_params, it_xyz, it_dsigma,
                                            it_dapp)

    def ours(case):
        return field_features_coords_grad(FieldConfig(), *case)

    row = {"n": it_xyz.shape[0],
           "iteration_live_samples":
               kernel_checks["iteration"]["samples_with_upstream"],
           "ms": time_ms(lambda: ours(it_inputs), graph=True),
           "eager_ms": time_ms(lambda: ours(it_inputs)),
           "plain_ms": time_ms(lambda: plain_coords_grad_chunked(
               it_params, it_xyz, it_dsigma, it_dapp), reps=3),
           "library_ms": time_ms(lib, reps=FT_REPS),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_max_rel_diff": lib_diff,
           "all_live_ms": time_ms(lambda: ours(live_case), graph=True),
           "all_live_bound_ms": coords_grad_bound(*live_case)[0]}
    del lib
    live_lib, live_lib_diff = library_coords_backward(*live_case)
    row.update(all_live_plain_ms=time_ms(
        lambda: plain_coords_grad_chunked(*live_case), reps=3),
        all_live_library_ms=time_ms(live_lib, reps=FT_REPS),
        all_live_library_max_rel_diff=live_lib_diff)
    del live_lib, it_inputs, it_params, it_xyz, it_dsigma, it_dapp, live_case
    torch.cuda.empty_cache()

    # the main path: estimate_pose_inerf at test_pose_estimation's settings
    t_err0, a_err0 = pose_errors(gt, start)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with kept_refine() as kept:
        _reset_counts()
        begin.record()
        t0 = time.perf_counter()
        loss, refined, history = estimate_pose_inerf(
            start, obs, cam_k, config, params, mask,
            sampling_strategy="random", lrate=INERF_LRATE,
            batch_size=INERF_BATCH, color_bkgd_aug="random",
            n_iters=INERF_ITERS, dice_loss=True, seed=SEED,
            return_history=True, device=dev)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        counts = _counts()
    events_ms = begin.elapsed_time(end)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = kept["out"][0].cpu().numpy()
    check(counts == {"banked_scores": 0, "fused_ray_scores": 0,
                     "gather_rows": INERF_ITERS,
                     "field_features": INERF_ITERS,
                     "field_features_backward": 0,
                     "field_features_coords_grad": INERF_ITERS,
                     "gather_rows_backward": 0, "cp_features": 0,
                     "cp_features_shared": 0, "cp_features_l1": 0,
                     "cp_features_backward": 0,
                     "cp_features_coords_grad": 0},
          f"a refinement iteration launches field_features, its coordinate "
          f"kernel and the mask lookup once each: {counts}")
    # finite only: the exponential map of a w that is not a unit vector is
    # not a rotation (the reference's CameraTransfer, and the JAX package's)
    check(np.isfinite(losses).all() and np.isfinite(refined).all(),
          "finite losses and pose")
    rot = refined[:3, :3].astype(np.float64)
    orthonormal_dev = float(np.abs(rot.T @ rot - np.eye(3)).max())
    t_err1, a_err1 = pose_errors(gt, refined)
    head, tail = float(losses[:50].mean()), float(losses[-50:].mean())
    check(tail < head, f"the rgb loss falls ({head} -> {tail})")
    check(t_err1 < INERF_GAIN * t_err0 and a_err1 < INERF_GAIN * a_err0,
          f"refinement: translation {t_err0} -> {t_err1}, angle {a_err0} -> "
          f"{a_err1}")
    trace = {str(k): pose_errors(gt, history[k])
             for k in (0, 50, 100, 200, 400, INERF_ITERS - 1)
             if k < INERF_ITERS}

    def some_iterations():
        run_refine(config, INERF_PROFILE_ITERS, SEED + 1)
        return INERF_PROFILE_ITERS

    profile = _profiled("inerf_iteration", some_iterations)

    # test_pose_estimation with the refinement, on the rendered frame; its
    # refinement (looked up in iffnerf_tpu_torch.inerf at each call) cut to
    # INERF_TPE_ITERS iterations
    frame = types.SimpleNamespace(all_rgbs=obs[None], poses=gt[None],
                                  img_wh=(FT_WH, FT_WH), K=cam_k[None])
    full_refinement = inerf_module.estimate_pose_inerf
    inerf_module.estimate_pose_inerf = lambda *a, **kw: full_refinement(
        *a, **dict(kw, n_iters=INERF_TPE_ITERS))
    try:
        _reset_counts()
        t0 = time.perf_counter()
        rows, tpe_t, tpe_a, _, _ = test_pose_estimation(
            frame, id_params, id_cfg, *rays, torch.tensor(UP),
            sequence_id="lego", inerf_refinement=True,
            nerf=(config, params, mask), log_fn=lambda *a: None, device=dev)
        tpe_s = _sync_s(t0)
        tpe_counts = _counts()
    finally:
        inerf_module.estimate_pose_inerf = full_refinement
    check(len(rows) == 1 and math.isfinite(tpe_t) and math.isfinite(tpe_a),
          f"test_pose_estimation with the refinement: {tpe_t}, {tpe_a}")
    check(tpe_counts["field_features_coords_grad"] == INERF_TPE_ITERS,
          f"test_pose_estimation's refinement ran its iterations through "
          f"the coordinate kernel: {tpe_counts}")
    emit(phase="inerf", grid=GRID, step_ratio=INERF_STEP_RATIO,
         n_samples=config.n_samples, batch=INERF_BATCH, iters=INERF_ITERS,
         target_render_s=sc.target_s, coverage=sc.coverage, routes=routes,
         iteration_live_samples=row["iteration_live_samples"],
         coords_kernel_checks=kernel_checks, tolerance=COORDS_GRAD_TOL,
         coords_kernel_at_iteration=row,
         errors_before={"translation": t_err0, "angle_deg": a_err0},
         errors_after={"translation": t_err1, "angle_deg": a_err1},
         errors_by_iteration=trace, final_rgb_loss=loss,
         refined_rotation_orthonormal_dev=orthonormal_dev,
         loss_first_50=head, loss_last_50=tail, launches=counts,
         launches_per_iteration={k: v / INERF_ITERS
                                 for k, v in counts.items()},
         frame_host_ms=host_ms, frame_events_ms=events_ms,
         iteration_host_ms=host_ms / INERF_ITERS,
         iteration_events_ms=events_ms / INERF_ITERS,
         profile=profile, peak_mem_gb=peak_gb,
         test_pose_estimation={"s": tpe_s, "translation_error": tpe_t,
                               "angular_error": tpe_a,
                               "refinement_iters": INERF_TPE_ITERS,
                               "launches": tpe_counts})
    entry = dict(
        name="field_features_coords_grad", route="cuda",
        source="iffnerf_tpu_torch/csrc/field_features.cu",
        replaces="iffnerf_tpu/ops/packed_sample.py:256",
        replaces_kind="g_weights of the XLA custom VJPs of the packed"
                      " gathers (_gather_contract_bwd :256,"
                      " _lerp_contract_mm_bwd :293); no pallas_call"
                      " differentiates this work",
        design="warp-specialised: a producer lane bulk-copies each"
               " stage's xyz, dsigma and dapp rows into a 2-stage mbarrier"
               " ring (L2 evict-first); one vote on each sample's whole"
               " upstream row (a stage with none stores zeros); the"
               " forward's cell pass writes each live sample's step; a"
               " group of lanes a run of 8 and axis-pair part walks the"
               " run's live samples with its corner words in registers,"
               " reading only the rows a cell enters, then sums the run by"
               " shuffles; the parts meet in a fixed order, one store a"
               " float",
        launches=counts["field_features_coords_grad"],
        launches_by_path={"inerf": counts["field_features_coords_grad"]},
        max_abs_err=kernel_checks["iteration"]["max_abs_err"], **row)
    return counts, entry


# ---------------------------------------------------------------------------
# real scenes: LLFF flower (NDC rays) and Mip-NeRF 360 bicycle
# ---------------------------------------------------------------------------


def _small_rotation(rng, max_deg):
    """A rotation by up to ``max_deg`` degrees about a random axis."""
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    angle = math.radians(rng.uniform(-max_deg, max_deg))
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + math.sin(angle) * k + (1 - math.cos(angle)) * k @ k


def synthetic_colours(n, img_wh, seed, dev):
    """[n * H * W, 3] smooth colours made on the card, a pattern over the
    pixel grid that shifts from view to view."""
    w, h = img_wh
    rng = np.random.default_rng(seed)
    v, u = torch.meshgrid(torch.arange(h, device=dev) / h,
                          torch.arange(w, device=dev) / w, indexing="ij")
    u, v = u.reshape(-1, 1), v.reshape(-1, 1)
    freq = torch.tensor([1.0, 2.0, 3.0], device=dev)
    return torch.cat([0.5 + 0.4 * torch.sin(6.0 * u * freq + 4.0 * v
                                            + 2 * math.pi * rng.random())
                      for _ in range(n)])


def _scene(rays, rgbs, img_wh, bbox, near_far, white_bg=False, **extra):
    return types.SimpleNamespace(
        all_rays=rays, all_rgbs=rgbs, img_wh=img_wh, scene_bbox=bbox,
        near_far=near_far, white_bg=white_bg, **extra)


def flower_scene(dev):
    """flower's cameras through the LLFF loader's own geometry
    (``llff_cameras``: the axis fix, ``center_poses``, the near-plane scale,
    ``get_spiral``; ``llff_split``; ``llff_rays``: ``rays_simple_np`` and
    ``ndc_rays_blender_np``), the colours synthetic -> (the train pool,
    flat, and a stacked test set of one view with K and the 120-pose path,
    on the card)."""
    rng = np.random.default_rng(SEED + 50)
    w, h = RS_FLOWER_WH
    bounds = np.zeros((RS_FLOWER_IMAGES, 17))
    for k in range(RS_FLOWER_IMAGES):
        t = [rng.uniform(-0.25, 0.25), rng.uniform(-0.25, 0.25),
             rng.normal(0.0, 0.02)]
        pose = np.concatenate([_small_rotation(rng, 2.0), np.array(t)[:, None],
                               np.array([[h], [w], [RS_FLOWER_FOCAL]])], 1)
        bounds[k] = np.concatenate([pose.reshape(-1),
                                    [rng.uniform(1.2, 1.6),
                                     rng.uniform(18.0, 25.0)]])
    poses, _, focal, img_wh, path = llff.llff_cameras(bounds, RS_DOWNSAMPLE)
    dirs = ray_directions_np(img_wh[1], img_wh[0], focal, blender=True)

    def rays_of(ids):
        return torch.cat([torch.from_numpy(llff.llff_rays(
            dirs, poses[i].astype(np.float32), focal, img_wh)).reshape(
                -1, 6).to(dev) for i in ids])

    train = llff.llff_split(RS_FLOWER_IMAGES, "train")
    test = llff.llff_split(RS_FLOWER_IMAGES, "test")[:1]
    bbox = llff.SCENE_BBOX.copy()
    pool = _scene(rays_of(train), synthetic_colours(len(train), img_wh,
                                                     SEED + 51, dev),
                  img_wh, bbox, (0.0, 1.0))
    shape = (1, img_wh[1], img_wh[0])
    k = np.array([[[focal[0], 0, img_wh[0] / 2], [0, focal[1], img_wh[1] / 2],
                   [0, 0, 1]]], np.float32)
    test_set = _scene(rays_of(test).reshape(shape + (6,)),
                      synthetic_colours(1, img_wh, SEED + 52, dev).reshape(
                          shape + (3,)),
                      img_wh, bbox, (0.0, 1.0), K=k, render_path=path)
    return pool, test_set, {"train_views": len(train), "test_views": 1,
                            "img_wh": list(img_wh), "focal": list(focal)}


def bicycle_scene(dev):
    """A Mip-NeRF 360 capture: RS_BICYCLE_IMAGES cameras on a ring 4 units
    round a point cloud (a dense core and a sparse far background), through
    the loader's ``normalize_scene`` (the camera-plane fit, the optical-axis
    intersection, the scale of the largest point extent), ``mip360_split``
    and ``mip360_rays`` (7 channels with mip radii), the colours synthetic
    -> (the train pool, flat, and a stacked test set of one view)."""
    rng = np.random.default_rng(SEED + 60)
    c2ws = []
    for k in range(RS_BICYCLE_IMAGES):
        theta = 2 * math.pi * (k + 0.2 * rng.random()) / RS_BICYCLE_IMAGES
        pos = np.array([4.0 * math.cos(theta), 4.0 * math.sin(theta),
                        rng.uniform(1.0, 2.0)])
        c2ws.append(_look_at_c2w(pos).astype(np.float64))
    xyz = np.concatenate([rng.normal(0.0, 1.0, (20000, 3)),
                          rng.uniform(-12.0, 12.0, (1000, 3))])
    c2ws, _, _ = mip360.normalize_scene(np.stack(c2ws), xyz)
    img_wh = tuple(int(x / RS_DOWNSAMPLE) for x in RS_BICYCLE_WH)
    f = RS_BICYCLE_FOCAL / RS_DOWNSAMPLE
    k = np.array([[[f, 0, img_wh[0] / 2], [0, f, img_wh[1] / 2], [0, 0, 1]]],
                 np.float32)
    camera = mip360.mip360_camera(k, img_wh)

    def rays_of(ids):
        return torch.cat([torch.from_numpy(mip360.mip360_rays(
            camera, c2ws[i].astype(np.float32))).reshape(-1, 7).to(dev)
            for i in ids])

    train = mip360.mip360_split(RS_BICYCLE_IMAGES, "train")
    test = mip360.mip360_split(RS_BICYCLE_IMAGES, "test")[:1]
    bbox = mip360.SCENE_BBOX.copy()
    pool = _scene(rays_of(train), synthetic_colours(len(train), img_wh,
                                                     SEED + 61, dev),
                  img_wh, bbox, mip360.NEAR_FAR)
    shape = (1, img_wh[1], img_wh[0])
    test_set = _scene(rays_of(test).reshape(shape + (7,)),
                      synthetic_colours(1, img_wh, SEED + 62, dev).reshape(
                          shape + (3,)),
                      img_wh, bbox, mip360.NEAR_FAR, K=k)
    return pool, test_set, {"train_views": len(train), "test_views": 1,
                            "img_wh": list(img_wh), "focal": [f, f],
                            "camera_radius": float(np.linalg.norm(
                                c2ws[:, :3, 3], axis=-1).mean())}


def train_real_scene(args, pool, test, reso, dev, init=None):
    """``train_field`` from a field made as ``reconstruction`` makes it
    (``init_field`` at ``reso`` over the pool's AABB, then ``init`` on its
    parameters when given), launch counts set to 0 just before and read
    just after, each step timed, the inputs of the first backward at the
    last grid kept -> a namespace of the run (with the trainer's log
    lines)."""
    config = field_config_from_args(args, pool.scene_bbox, reso,
                                    pool.near_far)
    params = init_field(torch.Generator(device=dev).manual_seed(SEED), config)
    if init is not None:
        params = init(params)
    events, lines = [], []
    torch.cuda.synchronize()
    with timed_field_steps() as steps, \
            captured_backwards(last_only=True) as caught:
        _reset_counts()
        t0 = time.perf_counter()
        config, params, mask = train_field(
            args, config, params, None, pool, test,
            str(WORK_DIR / f"real_{args.dataset_name}"),
            log_fn=lines.append, device=dev, events=events, reso_cur=reso)
        run_s = _sync_s(t0)
        counts = _counts()
    check(len(steps) == args.n_iters, f"{len(steps)} steps")
    check(counts["field_features"] >= args.n_iters
          and counts["field_features_backward"] == args.n_iters,
          f"every step launched field_features and its backward: {counts}; "
          f"events {events}; log {lines}; steps {steps}")
    check(counts["banked_scores"] == 0 and counts["fused_ray_scores"] == 0
          and counts["field_features_coords_grad"] == 0,
          f"field training runs no scoring or coordinate kernel: {counts}")
    mses = [st["mse"] for st in steps]
    check(all(math.isfinite(x) for x in mses), f"finite losses {mses}")
    check(all(a != b for a, b in zip(mses, mses[1:])),
          f"the loss changes from step to step {mses}")
    check(all(bool(torch.isfinite(a).all()) for a in leaves(params)),
          "finite trained parameters")
    (inputs,) = caught.values()
    return types.SimpleNamespace(config=config, params=params, mask=mask,
                                 steps=steps, events=events, counts=counts,
                                 run_s=run_s, caught=inputs, log=lines)


def kernel_holds(caught):
    """field_features' forward and backward at a step's inputs: each held
    to its chunked plain version, and each timed beside its bound, its plain
    version and the library call -> (forward row, backward row)."""
    p, xyz, dsigma, dapp = caught
    fwd = forward_errors(p, xyz)
    bwd = backward_errors(p, xyz, dsigma, dapp)
    b_row = dict(backward_row(p, xyz, dsigma, dapp), checks=bwd)
    del dsigma, dapp
    torch.cuda.empty_cache()
    f_row = dict(forward_row(p, xyz), checks=fwd)
    _, dims = kernel_layout(p, True)
    f_row["words_a_pair"] = [(dims[5 * i + 3] + dims[5 * i + 4]) // 4
                             for i in range(3)]
    return f_row, b_row


def render_real_scene(run, test, n_samples, ndc_ray, path_frames=0,
                      white_bg=False):
    """One test view (seconds, PSNR, peak memory) and ``path_frames`` of
    the test set's render path (seconds each), through ``evaluation`` and
    ``evaluation_path``."""
    log, plog = {}, {}
    torch.cuda.reset_peak_memory_stats()
    psnr = evaluation(test, run.config, run.params, run.mask, None, N_vis=-1,
                      n_samples=n_samples, white_bg=white_bg, ndc_ray=ndc_ray,
                      compute_extra_metrics=False, device=test.all_rays.device,
                      log=log)
    out = {"test_view_s": log["seconds"][0], "psnr": psnr[0],
           "n_samples": n_samples,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    check(len(psnr) == 1 and math.isfinite(psnr[0]), f"test PSNR {psnr}")
    if path_frames:
        frames = evaluation_path(
            run.config, run.params, run.mask, test.render_path[:path_frames],
            test, None, n_samples=n_samples, white_bg=white_bg,
            ndc_ray=ndc_ray,
            device=test.all_rays.device, log=plog)
        w, h = test.img_wh
        check(len(frames) == path_frames and all(
            f.shape == (h, w, 3) and f.dtype == np.uint8 for f in frames),
            "the path frames' shapes")
        out["path_frame_s"] = plog["seconds"]
        out["path_frames_of"] = len(test.render_path)
    return out


def real_scene_summary(run, args, holds, renders, scene, split, t_scene):
    grid = tuple(run.config.grid_size)
    uncaptured = [st["peak_mem_gb"] for k, st in enumerate(run.steps)
                  if k and st["grid"] == run.steps[k - 1]["grid"]]
    return {"config": f"configs/{Path(args.config).name}",
            "scene": scene, "scene_s": t_scene, "run_s": run.run_s,
            "final_grid": list(grid),
            "final_aabb": [list(a) for a in run.config.aabb],
            "n_samples_final": cal_n_samples(grid, args.step_ratio),
            "step_s": [st["s"] for st in run.steps],
            "mse": [st["mse"] for st in run.steps],
            "steps_by_grid": steps_by_grid(run.steps),
            "phase_events": run.events, "split": split,
            "peak_mem_gb": max(st["peak_mem_gb"] for st in run.steps),
            "peak_mem_gb_without_capture": max(uncaptured or [0.0]),
            "launches": run.counts, "forward": holds[0], "backward": holds[1],
            "renders": renders}


def phase_real_scenes(dev):
    """flower: ``train_field`` at configs/flower.txt's widths on NDC rays
    through its schedule (the upsamples and the mask update with its
    shrink) to the final grid; bicycle: ``train_field`` at
    configs/bicycle.txt's widths at its final grid. For each, the steps'
    seconds by grid, a step's split and profile, peak memory, the
    launches, ``field_features``' forward and backward at the last grid's
    first step held to their plain versions and timed beside their bounds,
    and renders. -> {scene: (launch counts, forward row, backward row)}."""
    out, result = {}, {}

    t0 = time.perf_counter()
    pool, test, scene = flower_scene(dev)
    t_scene = _sync_s(t0)
    args = config_args("flower", RS_FLOWER_ITERS, RS_FLOWER_UPSAMPLES,
                           (RS_FLOWER_MASK,))
    check(bool(args.ndc_ray) and args.dataset_name == "llff",
          "configs/flower.txt trains on NDC rays")
    reso = N_to_reso(args.N_voxel_init, pool.scene_bbox)
    run = train_real_scene(args, pool, test, reso, dev)
    kinds = [e["event"] for e in run.events]
    check(kinds == ["upsample", "alpha-mask update + shrink", "upsample",
                    "upsample", "upsample"], f"flower's phase events {kinds}")
    check(run.mask is not None and run.counts["gather_rows"] > 0,
          f"the mask lookup ran after the mask update: {run.counts}")
    check(math.prod(run.config.grid_size) > 0.9 * args.N_voxel_final,
          f"flower's final grid {run.config.grid_size}")
    n_final = cal_n_samples(run.config.grid_size, args.step_ratio)
    holds = kernel_holds(run.caught)
    run.caught = None
    torch.cuda.empty_cache()
    split = step_split_field(
        run.config, run.params, run.mask, pool, n_final, dev,
        weights={"l1": 0.0, "tv_d": args.TV_weight_density,
                 "tv_a": args.TV_weight_app},
        use_l1=False, use_tv_density=True, use_tv_app=True, ndc_ray=True)
    renders = render_real_scene(run, test, n_final, True, RS_PATH_FRAMES)
    out["flower"] = real_scene_summary(run, args, holds, renders, scene, split,
                                       t_scene)
    out["flower"]["start_grid"] = reso
    result["flower"] = (run.counts, *holds)
    del pool, test, run
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    pool, test, scene = bicycle_scene(dev)
    t_scene = _sync_s(t0)
    args = config_args("bicycle", RS_BICYCLE_STEPS, (10 ** 6,), (10 ** 6,))
    check(not args.ndc_ray and args.dataset_name == "mip360"
          and args.shadingMode == "Ref", "configs/bicycle.txt's field")
    reso = N_to_reso(args.N_voxel_final, pool.scene_bbox)
    run = train_real_scene(args, pool, test, reso, dev)
    check(run.events == [] and list(run.config.grid_size) == reso,
          f"bicycle's steps at {reso}: {run.config.grid_size}, {run.events}")
    n_final = cal_n_samples(reso, args.step_ratio)
    holds = kernel_holds(run.caught)
    run.caught = None
    torch.cuda.empty_cache()
    split = step_split_field(run.config, run.params, run.mask, pool, n_final,
                             dev)
    renders = render_real_scene(run, test, n_final, False)
    out["bicycle"] = real_scene_summary(run, args, holds, renders, scene,
                                        split, t_scene)
    result["bicycle"] = (run.counts, *holds)
    del pool, test, run
    torch.cuda.empty_cache()

    emit(phase="real_scenes", card=card_line(), **out, cuts={
        "flower": [f"{RS_FLOWER_ITERS} of 25000 iterations, the upsamples at "
                   f"{list(RS_FLOWER_UPSAMPLES)} and the mask update at "
                   f"{RS_FLOWER_MASK} (2000-5500 and 2500)",
                   "1 of 5 test views rendered",
                   f"{RS_PATH_FRAMES} of 120 path frames rendered"],
        "bicycle": [f"{RS_BICYCLE_IMAGES} of 194 images "
                    f"({len(mip360.mip360_split(RS_BICYCLE_IMAGES, 'train'))}"
                    " train views)",
                    f"{RS_BICYCLE_STEPS} of 30000 iterations, all at the final"
                    " grid (the schedule's earlier grids and its mask"
                    " updates not run)",
                    "1 test view rendered"]})
    return result


# ---------------------------------------------------------------------------
# object captures: CO3D and Repair (Metashape) loaders, mesh export, the
# unisphere contraction
# ---------------------------------------------------------------------------


def _ring_c2ws(n, radius, elevations_deg, rng):
    """``n`` OpenCV-convention c2w [4, 4] float64 on rings round the origin
    at the given elevations (split evenly), each looking at the origin with
    its azimuth jittered by up to a fifth of a step, the rig tilted by
    OC_RIG_TILT degrees about x."""
    tilt = np.eye(4)
    a = math.radians(OC_RIG_TILT)
    tilt[1:3, 1:3] = [[math.cos(a), -math.sin(a)], [math.sin(a), math.cos(a)]]
    out = []
    per_ring = -(-n // len(elevations_deg))
    for k in range(n):
        ring, j = divmod(k, per_ring)
        theta = 2 * math.pi * (j + 0.2 * rng.random()) / per_ring
        phi = math.radians(elevations_deg[ring])
        out.append(tilt @ _look_at_c2w(radius * np.array(
            [math.cos(theta) * math.cos(phi), math.sin(theta) * math.cos(phi),
             math.sin(phi)])).astype(np.float64))
    return out


def rgba_colours(n, img_wh, seed, dev):
    """``synthetic_colours`` with the blob mask as a fourth channel."""
    w, h = img_wh
    alpha = blob_mask(h, w, dev).float().reshape(-1, 1).repeat(n, 1)
    return torch.cat([synthetic_colours(n, img_wh, seed, dev), alpha], -1)


def write_co3d_sequence(root):
    """A CO3D sequence's annotation files only, in CO3D's layout under
    ``root``: ``<category>/frame_annotations.jgz`` (OC_CO3D_FRAMES frames
    of a phone video at OC_CO3D_WH on a ring round the object, their
    PyTorch3D NDC viewpoints made from OpenCV cameras as
    ``tests/test_co3d.py`` makes them) and ``<category>/set_lists/*.json``
    (every 10th frame held out) -> (category dir, sequence name)."""
    import gzip

    rng = np.random.default_rng(SEED + 70)
    category = Path(root) / OC_CO3D_CATEGORY
    (category / "set_lists").mkdir(parents=True, exist_ok=True)
    w, h = OC_CO3D_WH
    scale = min(h, w) / 2.0
    flip = np.diag([-1.0, -1.0, 1.0, 1.0])
    annotations, train, test = [], [], []
    for i, c2w in enumerate(_ring_c2ws(OC_CO3D_FRAMES, 3.0, (20.0,), rng)):
        m = np.linalg.inv(c2w)
        m[:3, :3] = m[:3, :3].T
        m = m @ np.linalg.inv(flip)
        img = f"{OC_CO3D_CATEGORY}/{OC_CO3D_SEQUENCE}/images/frame{i:06d}.jpg"
        cx, cy = w / 2 + rng.normal(0, 4), h / 2 + rng.normal(0, 4)
        annotations.append({
            "sequence_name": OC_CO3D_SEQUENCE, "frame_number": i,
            "image": {"path": img, "size": [h, w]},
            "mask": {"path": img.replace("images", "masks")[:-4] + ".png"},
            "viewpoint": {
                "R": m[:3, :3].tolist(), "T": m[:3, 3].tolist(),
                "focal_length": [-OC_CO3D_FOCAL / scale] * 2,
                "principal_point": [-(cx - w / 2) / scale,
                                    -(cy - h / 2) / scale]}})
        (test if i % 10 == 0 else train).append([OC_CO3D_SEQUENCE, i, img])
    with gzip.open(category / "frame_annotations.jgz", "wt") as fh:
        json.dump(annotations, fh)
    with open(category / "set_lists" / "set_lists_fewview.json", "w") as fh:
        json.dump({"train": train, "val": test, "test": test}, fh)
    return str(category), OC_CO3D_SEQUENCE


def co3d_capture(dev, root):
    """configs/co3d.txt's capture from its annotation files alone: the
    loader's ``read_category_annotations`` (the NDC-to-OpenCV conversion,
    recentring and rescaling) and ``co3d_rays`` (the K flip, 7-channel
    rays with mip radii at downsample_train), RGBA colours made on the
    card -> (train pool, a stacked test set of one view, the capture's
    sizes)."""
    category, sequence = write_co3d_sequence(root)
    frames, _, _ = co3d.read_category_annotations(category, sequence)
    img_wh = tuple(int(x / OC_DOWNSAMPLE) for x in OC_CO3D_WH)

    def rays_of(split):
        return torch.cat([torch.from_numpy(co3d.co3d_rays(
            K, c2w, img_wh, OC_DOWNSAMPLE)).reshape(-1, 7).to(dev)
            for _, c2w, K in split])

    train, test = frames["train"], frames["test"][:1]
    pool = _scene(rays_of(train), rgba_colours(len(train), img_wh,
                                               SEED + 71, dev),
                  img_wh, co3d.SCENE_BBOX.copy(), co3d.NEAR_FAR,
                  white_bg=True)
    shape = (1, img_wh[1], img_wh[0])
    test_set = _scene(rays_of(test).reshape(shape + (7,)),
                      rgba_colours(1, img_wh, SEED + 72, dev).reshape(
                          shape + (4,)),
                      img_wh, co3d.SCENE_BBOX.copy(), co3d.NEAR_FAR,
                      white_bg=True)
    return pool, test_set, {"frames": OC_CO3D_FRAMES,
                            "train_views": len(train),
                            "test_views_held_out": len(frames["test"]),
                            "img_wh": list(img_wh)}


REPAIR_XML = """<?xml version="1.0" encoding="UTF-8"?>
<document version="1.5.0">
  <chunk label="Chunk 1" enabled="true">
    <sensors>
      <sensor id="0" label="camera" type="frame">
        <resolution width="{w}" height="{h}"/>
        <calibration type="frame" class="adjusted">
          <resolution width="{w}" height="{h}"/>
          <f>{f}</f><cx>{cx}</cx><cy>{cy}</cy>
          <k1>-0.05</k1><k2>0.01</k2><p1>0.0002</p1><p2>-0.0001</p2>
        </calibration>
      </sensor>
    </sensors>
    <cameras>
{cameras}
    </cameras>
  </chunk>
</document>
"""


def repair_capture(dev, root):
    """configs/repair_27_RPf_00192b.txt's capture from a Metashape
    ``cameras.xml`` alone (one sensor, OC_REPAIR_CAMERAS cameras on three
    rings above the fragment, labels with their file extension so that no
    image is looked for): the loader's ``load_cameras_xml`` (recentring by
    the camera-plane fit, rescaling; cv2's undistorted K where cv2
    imports), ``repair_split`` and ``repair_rays`` (each camera's own K,
    7-channel rays with mip radii), RGBA colours made on the card ->
    (train pool, a stacked test set of one view with its K and the
    spiral path, the capture's sizes)."""
    rng = np.random.default_rng(SEED + 80)
    w, h = OC_REPAIR_WH
    cams = []
    for i, c2w in enumerate(_ring_c2ws(OC_REPAIR_CAMERAS, 2.5,
                                       (25.0, 45.0, 65.0), rng)):
        cams.append(f'      <camera id="{i}" sensor_id="0" '
                    f'label="IMG_{i:04d}.JPG"><transform>'
                    + " ".join(repr(float(v)) for v in c2w.reshape(-1))
                    + "</transform></camera>")
    base = Path(root) / "repair"
    base.mkdir(parents=True, exist_ok=True)
    (base / "cameras.xml").write_text(REPAIR_XML.format(
        w=w, h=h, f=OC_REPAIR_FOCAL, cx=w / 2 + 6.5, cy=h / 2 - 4.0,
        cameras="\n".join(cams)))
    cameras, _, _ = load_cameras_xml(str(base / "cameras.xml"), str(base),
                                     img_resize_factor=OC_DOWNSAMPLE)
    check(len(cameras["filenames"]) == OC_REPAIR_CAMERAS,
          f"{len(cameras['filenames'])} cameras parsed")
    img_wh = tuple(int(x / OC_DOWNSAMPLE) for x in OC_REPAIR_WH)
    poses = np.stack([repair.homogeneous(c) for c in cameras["cam2world"]])

    def rays_of(ids):
        return torch.cat([torch.from_numpy(repair.repair_rays(
            cameras["Ks"][i], poses[i], img_wh)).reshape(-1, 7).to(dev)
            for i in ids])

    train = repair.repair_split(OC_REPAIR_CAMERAS, "train")
    test = repair.repair_split(OC_REPAIR_CAMERAS, "test")
    bbox = repair.SCENE_BBOX.copy()
    pool = _scene(rays_of(train), rgba_colours(len(train), img_wh,
                                               SEED + 81, dev),
                  img_wh, bbox, repair.NEAR_FAR, white_bg=True)
    shape = (1, img_wh[1], img_wh[0])
    test_set = _scene(
        rays_of(test[:1]).reshape(shape + (7,)),
        rgba_colours(1, img_wh, SEED + 82, dev).reshape(shape + (4,)),
        img_wh, bbox, repair.NEAR_FAR, white_bg=True,
        K=cameras["Ks"][test[0]][None].astype(np.float32),
        render_path=repair.spiral_path(bbox, poses[test]))
    return pool, test_set, {"cameras": OC_REPAIR_CAMERAS,
                            "train_views": len(train),
                            "test_views_held_out": len(test),
                            "img_wh": list(img_wh),
                            "camera_radius": float(np.linalg.norm(
                                poses[:, :3, 3], axis=-1).mean())}


def object_density(params, aabb, feature=20.0, width=0.5):
    """Density factors that put a separable blob at the AABB's centre:
    each plane rank a(u)a(v) and each line rank a(w), a = c exp(-(x /
    width)^2) with c^3 x (3 pairs x ranks) = ``feature`` (a TensorCP
    field: each rank's three lines, c^3 x ranks = ``feature``), so that the
    density feature is ``feature`` exp(-|x|^2 / width^2) (sigma =
    softplus(feature - 10) about 10 at the centre, which the first steps'
    pull towards the background leave well above the mask's threshold): a
    young object field, which the first mask update shrinks to -> params
    with new density factors."""
    aabb = np.asarray(aabb, np.float32)
    ranks = params["density_line"][0].shape[1]
    pairs = 3 if "density_plane" in params else 1  # CP: one product a rank
    c = (feature / (pairs * ranks)) ** (1 / 3)
    dev = params["density_line"][0].device

    def axis(n, i):
        x = torch.linspace(float(aabb[0][i]), float(aabb[1][i]), n,
                           device=dev)
        return c * torch.exp(-(x / width) ** 2)

    out = dict(params)
    if "density_plane" in params:
        out["density_plane"] = tuple(
            (axis(p.shape[0], m1)[:, None] * axis(p.shape[1], m0)[None, :]
             )[..., None].expand(p.shape).contiguous()
            for p, (m0, m1) in zip(params["density_plane"], MAT_MODE))
    out["density_line"] = tuple(
        axis(l.shape[0], VEC_MODE[i])[:, None].expand(l.shape).contiguous()
        for i, l in enumerate(params["density_line"]))
    return out


def mesh_export(run, path):
    """``export_mesh_from_field`` on a trained field at its grid (the dense
    alpha through the density-only field_features on the card, marching
    cubes on the host), launch counts set to 0 just before and read just
    after; the PLY read back: its counts, every face index in range, every
    vertex inside the AABB; the dense alpha's device ms timed apart, and
    the marching-cubes library's g++ build (at first use) before it all."""
    t0 = time.perf_counter()
    build_marching_cubes()
    build_s = time.perf_counter() - t0
    log = {}
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    export_mesh_from_field(run.config, run.params, run.mask, str(path),
                           log=log)
    total_s = time.perf_counter() - t0
    counts = _counts()
    n_points = math.prod(run.config.grid_size)
    chunks = -(-n_points // DENSE_ALPHA_CHUNK)
    check(counts["field_features"] == chunks
          and counts["field_features_backward"] == 0
          and counts["gather_rows"] == (chunks if run.mask is not None else 0),
          f"the dense alpha's {chunks} chunks each launched field_features "
          f"(density only) and the mask lookup: {counts}")
    verts, faces = read_ply(path)
    aabb = np.asarray(run.config.aabb, np.float32)
    check(len(faces) == log["n_faces"] > 1000 and len(verts) == log["n_verts"],
          f"the PLY's counts {len(verts)}, {len(faces)}: {log}")
    check(int(faces.min()) >= 0 and int(faces.max()) < len(verts),
          "every face index in range")
    check(bool((verts >= aabb[0] - 1e-5).all() and (verts <= aabb[1] + 1e-5)
               .all()), "every vertex inside the AABB")
    with torch.no_grad():
        alpha_ms = time_ms(lambda: get_dense_alpha(run.config, run.params,
                                                   run.mask), reps=3)
    return dict(log, total_s=total_s, alpha_device_ms=alpha_ms,
                library_build_s=build_s,
                n_points=n_points, launches=counts,
                ply_mb=path.stat().st_size / 2 ** 20)


def beyond_unit(xyz):
    """The share of normalised coordinates beyond [-1, 1] and the largest
    |coordinate|."""
    return {"share_beyond_unit": float((xyz.abs() > 1).any(-1).float().mean()),
            "max_abs_coord": float(xyz.abs().max())}


def unisphere_run(dev):
    """configs/lego.txt's widths with ``--contraction_type unisphere`` (its
    300^3 grid over lego's AABB, the background samples to lego's far
    plane) from make_lego_field's density, no alpha mask, OC_UNI_STEPS
    steps on OC_UNI_FRAMES synthetic 800x800 frames made on the card
    (``synthetic_ray_pool``, lego's camera rig); ``field_features``'
    forward, backward and coordinate gradient held to their plain versions
    at the last step's samples, which reach beyond [-1, 1]."""
    pool = synthetic_ray_pool(dev, OC_UNI_FRAMES, SEED + 90)
    args = config_args("lego", OC_UNI_STEPS, (10 ** 6,), (10 ** 6,))
    args.contraction_type = "unisphere"
    config = field_config_from_args(args, pool.scene_bbox, (GRID,) * 3,
                                    pool.near_far)
    check(config.n_samples_bg > 0, "unisphere background samples")
    _, np_params, _ = make_lego_field(dev, GRID)
    params = params_from_numpy(np_params, device=dev)
    del np_params
    events = []
    with timed_field_steps() as steps, \
            captured_backwards(last_only=True) as caught:
        _reset_counts()
        t0 = time.perf_counter()
        config, params, mask = train_field(
            args, config, params, None, pool, pool,
            str(WORK_DIR / "unisphere"), log_fn=lambda *a: None, device=dev,
            events=events)
        run_s = _sync_s(t0)
        counts = _counts()
    mses = [st["mse"] for st in steps]
    check(len(steps) == OC_UNI_STEPS and all(math.isfinite(x) for x in mses)
          and counts["field_features_backward"] == OC_UNI_STEPS,
          f"unisphere steps {mses}, {counts}")
    (inputs,) = caught.values()
    p, xyz, dsigma, dapp = inputs
    out = {"grid": list(config.grid_size),
           "n_samples": config.n_samples, "n_samples_bg": config.n_samples_bg,
           "step_s": [st["s"] for st in steps], "mse": mses,
           "run_s": run_s, "launches": counts,
           "peak_mem_gb": max(st["peak_mem_gb"] for st in steps),
           "samples": beyond_unit(xyz),
           "forward": forward_errors(p, xyz),
           "backward": backward_errors(p, xyz, dsigma, dapp),
           "coords_grad": coords_grad_errors(p, xyz, dsigma, dapp)}
    check(out["samples"]["share_beyond_unit"] > 0,
          f"unisphere samples beyond [-1, 1]: {out['samples']}")
    return out, counts


def phase_object_captures(dev):
    """co3d: ``train_field`` at configs/co3d.txt's widths on a CO3D
    capture made by the loader's own functions, from a young object field
    through its schedule (the mask update with its shrink, the upsamples,
    the mask update with the ray filter) to its 300^3-voxel grid, a test
    view, then its mesh; repair: configs/repair_27_RPf_00192b.txt at its
    377x377x188 grid on a Metashape capture, a test view and a spiral-path
    frame; the unisphere contraction at lego's widths. For co3d and
    repair, ``field_features``' forward and backward held to their plain
    versions at the last grid's first step and timed beside their bounds,
    the coordinate kernel held too, a step's split and profile. -> {path:
    (launch counts, forward row, backward row)} for the kernels line."""
    import tempfile

    out, result = {}, {}
    root = tempfile.mkdtemp(dir=WORK_DIR)

    # co3d through its schedule
    t0 = time.perf_counter()
    pool, test, scene = co3d_capture(dev, root)
    t_scene = _sync_s(t0)
    args = config_args("co3d", OC_CO3D_ITERS, OC_CO3D_UPSAMPLES, OC_CO3D_MASKS)
    check(args.dataset_name == "co3d" and args.fea2denseAct == "softplus"
          and args.density_shift == -10.0 and args.distance_scale == 25.0
          and args.rm_weight_mask_thre == 1e-2, "configs/co3d.txt's field")
    reso = N_to_reso(args.N_voxel_init, pool.scene_bbox)
    run = train_real_scene(args, pool, test, reso, dev,
                           init=lambda p: object_density(p, pool.scene_bbox))
    kinds = [e["event"] for e in run.events]
    check(kinds == ["alpha-mask update + shrink", "upsample", "upsample",
                    "alpha-mask update + ray filtering", "upsample",
                    "upsample", "upsample"], f"co3d's phase events {kinds}")
    check(run.mask is not None and run.counts["gather_rows"] > 0,
          f"the mask lookup ran after the mask update: {run.counts}")
    kept = [float(ln.split()[-1]) for ln in run.log if "Ray filtering" in ln]
    check(len(kept) == 2 and 0.05 < kept[1] <= 1.0,
          f"the ray filter kept part of the rays: {run.log}")
    check(math.prod(run.config.grid_size) > 0.9 * args.N_voxel_final,
          f"co3d's final grid {run.config.grid_size}")
    check(np.ptp(np.asarray(run.config.aabb), 0).max() < 1.9,
          f"the first mask update shrank the AABB: {run.config.aabb}")
    n_final = cal_n_samples(run.config.grid_size, args.step_ratio)
    coords = coords_grad_errors(*run.caught)
    holds = kernel_holds(run.caught)
    run.caught = None
    torch.cuda.empty_cache()
    split = step_split_field(
        run.config, run.params, run.mask, pool, n_final, dev,
        weights={"l1": args.L1_weight_rest, "tv_d": args.TV_weight_density,
                 "tv_a": args.TV_weight_app},
        use_l1=True, use_tv_density=True, use_tv_app=True)
    renders = render_real_scene(run, test, n_final, False, white_bg=True)
    mesh = mesh_export(run, WORK_DIR / "co3d_mesh.ply")
    out["co3d"] = real_scene_summary(run, args, holds, renders, scene, split,
                                     t_scene)
    out["co3d"].update(
        start_grid=reso, coords_grad=coords, mesh=mesh,
        ray_filter_kept=kept)
    result["co3d"] = (run.counts, *holds)
    result["mesh"] = (mesh["launches"], None, None)
    del pool, test, run
    torch.cuda.empty_cache()

    # repair at its final grid
    t0 = time.perf_counter()
    pool, test, scene = repair_capture(dev, root)
    t_scene = _sync_s(t0)
    args = config_args("repair_27_RPf_00192b", OC_REPAIR_STEPS, (10 ** 6,),
                       (10 ** 6,))
    check(args.dataset_name == "repair" and args.fea2denseAct == "relu"
          and list(args.n_lamb_sigma) == [16, 16, 4]
          and list(args.n_lamb_sh) == [48, 48, 12],
          "configs/repair_27_RPf_00192b.txt's field")
    reso = N_to_reso(args.N_voxel_final, pool.scene_bbox)
    check(reso == [377, 377, 188], f"repair's final grid {reso}")
    run = train_real_scene(args, pool, test, reso, dev)
    check(run.events == [] and list(run.config.grid_size) == reso,
          f"repair's steps at {reso}: {run.config.grid_size}, {run.events}")
    n_final = cal_n_samples(reso, args.step_ratio)
    coords = coords_grad_errors(*run.caught)
    holds = kernel_holds(run.caught)
    run.caught = None
    torch.cuda.empty_cache()
    split = step_split_field(
        run.config, run.params, run.mask, pool, n_final, dev,
        weights={"l1": 0.0, "tv_d": args.TV_weight_density,
                 "tv_a": args.TV_weight_app},
        use_l1=False, use_tv_density=True, use_tv_app=True)
    renders = render_real_scene(run, test, n_final, False, 1, white_bg=True)
    out["repair"] = real_scene_summary(run, args, holds, renders, scene,
                                       split, t_scene)
    out["repair"]["coords_grad"] = coords
    result["repair"] = (run.counts, *holds)
    del pool, test, run
    torch.cuda.empty_cache()

    uni, uni_counts = unisphere_run(dev)
    out["unisphere"] = uni
    result["unisphere"] = (uni_counts, None, None)
    torch.cuda.empty_cache()

    emit(phase="object_captures", card=card_line(), **out, cuts={
        "co3d": [f"{OC_CO3D_ITERS} of 30000 iterations, the upsamples at "
                 f"{list(OC_CO3D_UPSAMPLES)} and the mask updates at "
                 f"{list(OC_CO3D_MASKS)} (2000-7000 and 2000, 4000)",
                 "from a young object field (a density blob) in place of "
                 "2000 iterations of training",
                 f"1 of {len(range(0, OC_CO3D_FRAMES, 10))} test views "
                 "rendered"],
        "repair": [f"{OC_REPAIR_STEPS} of 9000 iterations, all at the final"
                   " grid (the schedule's earlier grids and its mask"
                   " updates not run)", "1 test view and 1 of 100 spiral"
                   " path frames rendered"],
        "unisphere": [f"{OC_UNI_STEPS} steps at lego's final grid on "
                      f"{OC_UNI_FRAMES} of lego's 100 frames, no alpha mask"]})
    return result


# ---------------------------------------------------------------------------
# TensorCP fields
# ---------------------------------------------------------------------------


def cp_args(ckpt=None):
    """configs/lego.txt with the upstream CP block's flags (CP_FLAGS) on the
    command line, cut to FT_ITERS iterations with the upsamples and mask
    updates at FT_EVENTS."""
    return config_args("lego", FT_ITERS, FT_EVENTS, FT_EVENTS, ckpt,
                       extra=CP_FLAGS)


@contextlib.contextmanager
def captured_cp(name, keep):
    """Keeps a copy of the inputs of the CP launcher ``name`` (``_launch_
    forward``, ``_launch_backward`` or ``_launch_coords_grad``) at the
    calls ``keep(dims, flat)`` accepts, the last such call's, while open
    -> {"inputs": (params, xyz, dsigma, dapp)} (no upstream for the
    forward)."""
    out = {}
    launch = getattr(cp_features_module, name)

    def capture(lines, dims, flat, *rest):
        if keep(dims, flat):
            out.clear()
            params = {"density_line": tuple(a.detach().clone()
                                            for a in lines[:3]),
                      "app_line": tuple(a.detach().clone()
                                        for a in lines[3:]
                                        if a is not None) or None}
            ups = ([u if u is None else u.clone() for u in rest[:2]]
                   if name != "_launch_forward" else [None, None])
            out["inputs"] = (params, flat.clone(), *ups)
        return launch(lines, dims, flat, *rest)

    setattr(cp_features_module, name, capture)
    try:
        yield out
    finally:
        setattr(cp_features_module, name, launch)


def first_call():
    """A ``keep`` for ``captured_cp`` that accepts the first call only."""
    seen = []

    def keep(dims, flat):
        seen.append(flat.shape[0])
        return len(seen) == 1
    return keep


def cp_random_upstream(params, xyz, seed):
    """dsigma [N] and dapp [N, R_app] for ``xyz``, normal, a third of the
    samples without upstream (as masked samples), from ``seed``."""
    rng = np.random.default_rng(seed)
    n, ra = xyz.shape[0], params["app_line"][0].shape[1]
    live = torch.as_tensor(rng.random(n) > 1 / 3, device=xyz.device)
    dsigma = torch.as_tensor(rng.standard_normal(n, dtype=np.float32),
                             device=xyz.device) * live
    dapp = torch.as_tensor(rng.standard_normal((n, ra), dtype=np.float32),
                           device=xyz.device) * live[:, None]
    return dsigma, dapp


def cp_all_live_inputs(params, dev):
    """The CP coordinate kernel's all-live input at ``params``' lines:
    CP_LIVE_RAYS rays in random directions of CP_LIVE_PER_RAY samples half
    a texel apart (``ray_ordered_samples`` on the lines' lengths), every
    upstream word normal (numpy, from the seed) -> (params, xyz, dsigma,
    dapp)."""
    grid = tuple(a.shape[0] for a in params["density_line"])[::-1]
    dirs = np.random.default_rng(SEED + 63).standard_normal((CP_LIVE_RAYS, 3))
    xyz = ray_ordered_samples(grid, dirs, CP_LIVE_PER_RAY, SEED + 64,
                              spread=INERF_LIVE_SPREAD)
    rng = np.random.default_rng(SEED + 65)
    n, ra = xyz.shape[0], params["app_line"][0].shape[1]
    dsigma = rng.standard_normal(n, dtype=np.float32)
    dapp = rng.standard_normal((n, ra), dtype=np.float32)
    return (params, *(torch.as_tensor(a, device=dev)
                      for a in (xyz, dsigma, dapp)))


def cp_chunked(fn, xyz, *ups, total=False):
    """``fn(xyz_chunk, *ups_chunk)`` over chunks of FT_PLAIN_CHUNK samples
    -> the outputs concatenated, or summed leaf by leaf with ``total``."""
    outs = [fn(xyz[i:i + FT_PLAIN_CHUNK],
               *(None if u is None else u[i:i + FT_PLAIN_CHUNK] for u in ups))
            for i in range(0, xyz.shape[0], FT_PLAIN_CHUNK)]
    if total:
        return {k: tuple(sum(o[k][j] for o in outs) for j in range(3))
                for k in outs[0]}
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def cp_library_lines(params):
    """The lines as [1, R, L, 1], the layout F.grid_sample takes."""
    return {k: [a.T[None, :, :, None].contiguous() for a in params[k]]
            for k in ("density_line", "app_line")}


def cp_library_features(lines, coords):
    """cp_features' function from F.grid_sample on the three lines (a
    timing yardstick; the port never calls it) -> (sigma [N], app [N, R])."""
    zero = torch.zeros_like(coords[:, 0])

    def products(kind):
        prod = None
        for i in range(3):
            grid = torch.stack([zero, coords[:, VEC_MODE[i]]], -1)[None, :, None]
            f = F.grid_sample(lines[kind][i], grid, align_corners=True)[0, :, :, 0]
            prod = f if prod is None else prod * f
        return prod

    return products("density_line").sum(0), products("app_line").T


def cp_library_coords(lines, xyz, dsigma, dapp):
    """The coordinate gradient from F.grid_sample's backward on the three
    lines (``cp_library_lines``), in chunks of FT_PLAIN_CHUNK samples (a
    timing yardstick; the port never calls it)."""
    for i in range(0, xyz.shape[0], FT_PLAIN_CHUNK):
        x = xyz[i:i + FT_PLAIN_CHUNK].detach().requires_grad_()
        s, a = cp_library_features(lines, x)
        torch.autograd.grad((s, a), x, (dsigma[i:i + FT_PLAIN_CHUNK],
                                        dapp[i:i + FT_PLAIN_CHUNK]))


def cp_rows(params, xyz, live=None):
    """Rows of each line that the samples (those ``live``) touch: the
    unique in-range corner rows of each axis -> [3] counts."""
    pts = xyz if live is None else xyz[live]
    out = []
    for i, line in enumerate(params["density_line"]):
        idx, valid, _ = corners_1d(line.shape[0], pts[:, VEC_MODE[i]])
        out.append(torch.unique(idx[valid]).numel())
    return out


def cp_forward_bound(params, xyz):
    """Bytes of the CP forward at ``xyz`` (the coordinates read, sigma and
    the products written once, the rows the samples touch read once) ->
    (ms, bound_by)."""
    n = xyz.shape[0]
    rd, ra = (params[k][0].shape[1] for k in ("density_line", "app_line"))
    rows = sum(cp_rows(params, xyz))
    return bound(n * 12 + n * 4 + n * ra * 4 + rows * (rd + ra) * 4, 0.0,
                 torch.float32)


def cp_bounds(params, xyz, dsigma, dapp):
    """Bytes of the three CP kernels at these inputs (each input read once,
    each output written once; the rows the samples touch read once, a
    gradient row written once) -> {kernel: (ms, bound_by)}."""
    n = xyz.shape[0]
    rd, ra = (params[k][0].shape[1] for k in ("density_line", "app_line"))
    live = (dsigma != 0) | (dapp != 0).any(-1)
    live_rows = sum(cp_rows(params, xyz, live))
    up = n * 4 + dapp.numel() * 4
    return {"forward": cp_forward_bound(params, xyz),
            "backward": bound(n * 12 + up + 2 * live_rows * (rd + ra) * 4,
                              0.0, torch.float32),
            "coords_grad": bound(n * 12 + up + n * 12
                                 + live_rows * (rd + ra) * 4, 0.0,
                                 torch.float32)}


def cp_forward_holds(config, params, xyz, label):
    """The CP forward at ``xyz`` against its plain version (chunked): app
    products bit-equal, sigma within FIELD_RTOL and FIELD_ATOL x
    max|plain|, a second call bit-equal; then timed (graph and eager)
    beside its bound, its plain version and F.grid_sample on the three
    lines (chunked at more than FT_PLAIN_CHUNK samples) -> the row."""
    n = xyz.shape[0]
    with torch.no_grad():
        sigma, app = cp_features(config, params, xyz)
        again = cp_features(config, params, xyz)
        want = cp_chunked(lambda x: cp_features_plain(params, x, True,
                                                      gather_rows_plain), xyz)
        scale = float(want[0].abs().max())
        row = {"n": n, "app_bit_equal": bool(torch.equal(app, want[1])),
               "repeat_bit_equal": bool(torch.equal(sigma, again[0])
                                        and torch.equal(app, again[1])),
               "sigma_max_abs_err": float((sigma - want[0]).abs().max()),
               "sigma_max_abs_plain": scale}
        check(row["app_bit_equal"] and row["repeat_bit_equal"]
              and torch.allclose(sigma, want[0], rtol=FIELD_RTOL,
                                 atol=FIELD_ATOL * scale),
              f"cp_features vs plain at {label}: {row}")
        row["max_abs_err"] = max(row["sigma_max_abs_err"],
                                 float((app - want[1]).abs().max()))
        del sigma, app, again, want
        torch.cuda.empty_cache()
        lines = cp_library_lines(params)
        row["bound_ms"], row["bound_by"] = cp_forward_bound(params, xyz)
        row.update(
            ms=time_ms(lambda: cp_features(config, params, xyz), reps=FT_REPS,
                       graph=True),
            eager_ms=time_ms(lambda: cp_features(config, params, xyz),
                             reps=FT_REPS),
            plain_ms=time_ms(lambda: cp_chunked(lambda x: cp_features_plain(
                params, x, True, gather_rows_plain), xyz), reps=3),
            library_ms=time_ms(lambda: cp_chunked(
                lambda x: cp_library_features(lines, x), xyz), reps=3),
            library_chunked=n > FT_PLAIN_CHUNK)
    torch.cuda.empty_cache()
    return row


def cp_kernel_holds(config, params, xyz, dsigma, dapp, label):
    """The three CP kernels at ``xyz`` and its upstream against their plain
    versions (chunked): the forward as ``cp_forward_holds`` holds it, the
    line gradient within CP_GRAD_TOL of each line's largest, the
    coordinate gradient within COORDS_GRAD_TOL of the largest; then each
    timed (graph and eager) beside its bound, its plain version and
    F.grid_sample (chunked at more than FT_PLAIN_CHUNK samples) ->
    {kernel: row}."""
    n = xyz.shape[0]
    rows = {"forward": cp_forward_holds(config, params, xyz, label)}
    got = cp_features_backward(config, params, xyz, dsigma, dapp)
    want = cp_chunked(lambda *a: cp_features_backward_plain(params, *a), xyz,
                      dsigma, dapp, total=True)
    worst, leaf, err_max = 0.0, "", 0.0
    for name in want:
        for i, (a, b) in enumerate(zip(got[name], want[name])):
            err = float((a - b).abs().max())
            share = err / (CP_GRAD_TOL * max(float(b.abs().max()), 1e-30))
            err_max = max(err_max, err)
            if share >= worst:
                worst, leaf = share, f"{name}[{i}]"
    bwd = {"n": n, "worst_share_of_tolerance": worst, "worst_leaf": leaf,
           "max_abs_err": err_max,
           "samples_with_grad": int(((dsigma != 0)
                                     | (dapp != 0).any(-1)).sum())}
    check(worst <= 1.0, f"cp_features backward vs plain at {label}: {bwd}")
    del got, want
    got = cp_features_coords_grad(config, params, xyz, dsigma, dapp)
    want = cp_chunked(lambda *a: cp_features_coords_grad_plain(params, *a),
                      xyz, dsigma, dapp)
    cscale = float(want.abs().max())
    coords = {"n": n, "max_abs_err": float((got - want).abs().max()),
              "max_abs_plain": cscale}
    coords["share_of_tolerance"] = coords["max_abs_err"] / (
        COORDS_GRAD_TOL * max(cscale, 1e-30))
    check(coords["share_of_tolerance"] <= 1.0,
          f"cp_features coordinate gradient vs plain at {label}: {coords}")
    del got, want
    torch.cuda.empty_cache()

    bounds = cp_bounds(params, xyz, dsigma, dapp)
    lines = cp_library_lines(params)
    chunked = n > FT_PLAIN_CHUNK
    lib_lines = {k: [a.detach().clone().requires_grad_() for a in v]
                 for k, v in lines.items()}

    def lib_backward():
        for i in range(0, n, FT_PLAIN_CHUNK):
            s, a = cp_library_features(lib_lines, xyz[i:i + FT_PLAIN_CHUNK])
            torch.autograd.grad((s, a), lib_lines["density_line"]
                                + lib_lines["app_line"],
                                (dsigma[i:i + FT_PLAIN_CHUNK],
                                 dapp[i:i + FT_PLAIN_CHUNK]))

    def lib_coords():
        cp_library_coords(lines, xyz, dsigma, dapp)

    calls = {
        "backward": (lambda: cp_features_backward(config, params, xyz, dsigma,
                                                  dapp),
                     lambda: cp_chunked(lambda *a: cp_features_backward_plain(
                         params, *a), xyz, dsigma, dapp, total=True),
                     lib_backward, bwd),
        "coords_grad": (lambda: cp_features_coords_grad(config, params, xyz,
                                                        dsigma, dapp),
                        lambda: cp_chunked(lambda *a: (
                            cp_features_coords_grad_plain(params, *a)),
                            xyz, dsigma, dapp),
                        lib_coords, coords)}
    for kernel, (call, plain, lib, checks) in calls.items():
        with torch.no_grad():
            ms = time_ms(call, reps=FT_REPS, graph=True)
            eager = time_ms(call, reps=FT_REPS)
        rows[kernel] = dict(
            checks, ms=ms, eager_ms=eager,
            plain_ms=time_ms(plain, reps=3), library_ms=time_ms(lib, reps=3),
            library_chunked=chunked, bound_ms=bounds[kernel][0],
            bound_by=bounds[kernel][1])
        torch.cuda.empty_cache()
    return rows


def cp_coords_holds(config, params, xyz, dsigma, dapp, label):
    """The CP coordinate kernel at these inputs against its plain version
    (chunked) within COORDS_GRAD_TOL of the largest |dxyz|, three calls
    bit-equal; then timed (graph and eager) beside its bound, its plain
    version and F.grid_sample's backward on the three lines -> the row."""
    got = cp_features_coords_grad(config, params, xyz, dsigma, dapp)
    want = cp_chunked(lambda *a: cp_features_coords_grad_plain(params, *a),
                      xyz, dsigma, dapp)
    scale = float(want.abs().max())
    row = {"n": xyz.shape[0], "max_abs_err": float((got - want).abs().max()),
           "max_abs_plain": scale,
           "samples_with_upstream": int(((dsigma != 0)
                                         | (dapp != 0).any(-1)).sum()),
           "repeats_bit_equal": all(torch.equal(got, cp_features_coords_grad(
               config, params, xyz, dsigma, dapp)) for _ in range(2))}
    row["share_of_tolerance"] = row["max_abs_err"] / (
        COORDS_GRAD_TOL * max(scale, 1e-30))
    check(row["share_of_tolerance"] <= 1.0 and row["repeats_bit_equal"],
          f"the CP coordinate kernel at {label}: {row}")
    del got, want
    torch.cuda.empty_cache()
    with torch.no_grad():
        row["ms"] = time_ms(lambda: cp_features_coords_grad(
            config, params, xyz, dsigma, dapp), reps=FT_REPS, graph=True)
        row["eager_ms"] = time_ms(lambda: cp_features_coords_grad(
            config, params, xyz, dsigma, dapp), reps=FT_REPS)
    row["bound_ms"], row["bound_by"] = cp_bounds(
        params, xyz, dsigma, dapp)["coords_grad"]
    row["plain_ms"] = time_ms(lambda: cp_chunked(
        lambda *a: cp_features_coords_grad_plain(params, *a), xyz, dsigma,
        dapp), reps=3)
    lines = cp_library_lines(params)
    row["library_ms"] = time_ms(
        lambda: cp_library_coords(lines, xyz, dsigma, dapp), reps=3)
    torch.cuda.empty_cache()
    return row


def k3_runs(idx):
    """The runs of equal indices in ``idx`` [N]: 1 + the positions n where
    idx[n] != idx[n - 1] (0 for no entry)."""
    return int((idx[1:] != idx[:-1]).sum()) + 1 if idx.numel() else 0


def k3_backward_holds(table_rows, idx, up, label):
    """K3's backward at ``idx`` [N] int32 and ``up`` [N, C] into a table of
    ``table_rows`` rows against index_add_ (gather_rows_backward_plain)
    within CP_GRAD_TOL of its largest; timed (graph and eager) beside its
    bound (the upstream and indices read once, each touched row read and
    written once), its plain version and one index_add_; its plan's slice
    width and slices and the runs of equal indices (an add a run and slice)
    -> the row."""
    got = gather_rows_backward(up, idx, table_rows)
    want = gather_rows_backward_plain(up, idx, table_rows)
    err = float((got - want).abs().max())
    share = err / (CP_GRAD_TOL * max(float(want.abs().max()), 1e-30))
    check(share <= 1.0, f"K3 backward vs index_add_ at {label}: {share}")
    del got, want
    touched = torch.unique(idx).numel()
    c = up.shape[1]
    ms, by = bound(up.numel() * 4 + idx.numel() * 4 + 2 * touched * c * 4,
                   0.0, torch.float32)
    plan = backward_plan(table_rows, c, idx.shape[0],
                         _build.sm_count(up.device), up.data_ptr() % 16 == 0)
    long_idx = idx.long()

    def library():
        return torch.zeros((table_rows, c), device=up.device).index_add_(
            0, long_idx, up)

    return {"table": [table_rows, c], "n": idx.shape[0], "max_abs_err": err,
            "share_of_tolerance": share, "slice_cols": plan.slice_cols, "slices": plan.slices,
            "runs": k3_runs(idx),
            "ms": time_ms(lambda: gather_rows_backward(up, idx, table_rows),
                          reps=FT_REPS, graph=True),
            "eager_ms": time_ms(lambda: gather_rows_backward(
                up, idx, table_rows), reps=FT_REPS),
            "plain_ms": time_ms(lambda: gather_rows_backward_plain(
                up, idx, table_rows), reps=3),
            "library_ms": time_ms(library, reps=3),
            "bound_ms": ms, "bound_by": by}


@contextlib.contextmanager
def captured_k3_backward():
    """Keeps the inputs of every launch of K3's backward while open ->
    [(upstream [N, C], idx [N], table rows)], in launch order."""
    out = []
    launch = gather_module._launch_backward

    def capture(grad, idx, rows):
        out.append((grad, idx, rows))
        return launch(grad, idx, rows)

    gather_module._launch_backward = capture
    try:
        yield out
    finally:
        gather_module._launch_backward = launch


def sampler_step(config, params, mask, pool, n_samples, dev):
    """One training step's loss of CP_SAMPLER_RAYS rays of ``pool`` under
    ``config`` (rays and jitter drawn from SEED + 60), its backward taken
    -> (the loss, the trainable leaves' gradients)."""
    rng = np.random.default_rng(SEED + 60)
    rows = torch.as_tensor(rng.integers(0, pool.all_rays.shape[0],
                                        CP_SAMPLER_RAYS), device=dev)
    jitter = torch.as_tensor(rng.random((CP_SAMPLER_RAYS, 1),
                                        dtype=np.float32), device=dev)
    p = trainable(params, dev)
    total, _ = field_trainer.field_loss(
        config, p, mask, pool.all_rays[rows], pool.all_rgbs[rows],
        torch.ones(3, device=dev), {"l1": 1e-5, "tv_d": 0.0, "tv_a": 0.0},
        n_samples=n_samples, jitter=jitter, use_l1=True)
    total.backward()
    torch.cuda.synchronize()
    return float(total.detach()), [a.grad for a in leaves(p)]


def cp_sampler_route(config, params, mask, pool, n_samples, dev):
    """``sampler_step`` at the final grid through the CP kernels and
    through the samplers (fused_eval "off": K3 and its backward), the same
    rays and jitter: the loss within 1e-5 and each leaf's gradient within
    POSE_GRAD_TOL of its largest; launch counts of each route set to 0 just
    before it and read just after; the samplers' K3-backward launches held
    to index_add_ and timed one by one (``k3_backward_holds``) -> (the
    samplers' counts, the comparison and the launches' rows)."""
    out, counts = {}, {}
    for route, cfg in (("cp_kernel", config),
                       ("samplers", config.replace(fused_eval="off"))):
        with captured_k3_backward() as k3_inputs:
            _reset_counts()
            out[route] = sampler_step(cfg, params, mask, pool, n_samples, dev)
            counts[route] = _counts()
    check(counts["cp_kernel"]["cp_features_backward"] == 1
          and counts["cp_kernel"]["gather_rows_backward"] == 0,
          f"the CP route's launches {counts['cp_kernel']}")
    check(counts["samplers"]["cp_features"] == 0
          and counts["samplers"]["gather_rows_backward"] > 0,
          f"the samplers' route launched K3's backward: {counts['samplers']}")
    loss_diff = abs(out["cp_kernel"][0] - out["samplers"][0])
    pairs = list(zip(out["cp_kernel"][1], out["samplers"][1]))
    check(all((a is None) == (b is None) for a, b in pairs),
          "both routes reach the same leaves")
    worst = max(float((a - b).abs().max()) / (
        POSE_GRAD_TOL * max(float(b.abs().max()), 1e-30))
        for a, b in pairs if b is not None)
    check(loss_diff <= 1e-5 * abs(out["samplers"][0]) and worst <= 1.0,
          f"CP kernels' and samplers' step agree ({loss_diff}, {worst})")
    del out
    check(len(k3_inputs) == counts["samplers"]["gather_rows_backward"],
          f"{len(k3_inputs)} K3-backward launches captured")
    launches = [k3_backward_holds(r, i, u, f"the samplers' step, launch {k}")
                for k, (u, i, r) in enumerate(k3_inputs)]
    del k3_inputs
    torch.cuda.empty_cache()
    return counts["samplers"], {
        "rays": CP_SAMPLER_RAYS, "n_samples": n_samples,
        "loss_abs_diff": loss_diff, "worst_grad_share_of_tolerance": worst,
        "k3_backward_launches": launches,
        "k3_backward_count": len(launches),
        "k3_backward_sum": {k: sum(row[k] for row in launches)
                            for k in ("ms", "eager_ms", "plain_ms",
                                      "library_ms", "bound_ms")}}


def train_cp(dev):
    """TensoRF training through ``train_field`` at TensoRF's CP setting
    (``cp_args``) on the field_train phase's pool (100 synthetic 800x800
    frames made on the card), from a 128^3 CP field with a density blob
    (``object_density``) saved and loaded back; launch counts set to 0
    just before the run and read just after; each step timed, the inputs
    of the last grid's first backward kept -> a namespace."""
    WORK_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    pool = synthetic_ray_pool(dev, FT_POOL, SEED + 20)
    test = synthetic_ray_pool(dev, 1, SEED + 21, stacked=True)
    pool_s = _sync_s(t0)
    args = cp_args(WORK_DIR / "lego_cp_128.npz")
    config = field_config_from_args(args, pool.scene_bbox,
                                    (FT_GRID_INIT,) * 3, pool.near_far)
    check(config.model_name == "TensorCP"
          and config.density_n_comp == (96,) * 3
          and config.app_n_comp == (288,) * 3
          and args.N_voxel_final == 500 ** 3
          and args.L1_weight_inital == args.L1_weight_rest == 1e-5,
          f"the CP block's setting: {config}")
    params = object_density(init_field(torch.Generator(device=dev)
                                       .manual_seed(SEED), config),
                            config.aabb)
    save_field(str(args.ckpt), config, params)
    del params
    config, params, mask = load_field(args.ckpt, device=dev)
    check(config.model_name == "TensorCP" and mask is None,
          "the CP field round-trips")
    events = []
    last = {}

    def keep(dims, flat):  # the first backward at each new grid
        key = tuple(dims[:3])
        fresh = last.get("key") != key
        last["key"] = key
        return fresh

    torch.cuda.synchronize()
    with timed_field_steps() as steps, \
            captured_cp("_launch_backward", keep) as caught, \
            count_torch_lerps() as torch_lerps:
        _reset_counts()
        t0 = time.perf_counter()
        config, params, mask = train_field(
            args, config, params, mask, pool, test,
            str(WORK_DIR / "tensor_cp"), log_fn=lambda *a: None, device=dev,
            events=events,
            reso_cur=N_to_reso(args.N_voxel_init, pool.scene_bbox))
        run_s = _sync_s(t0)
        counts = _counts()
    return types.SimpleNamespace(
        args=args, config=config, params=params, mask=mask, pool=pool,
        steps=steps, events=events, counts=counts,
        torch_lerps=torch_lerps["n"], caught=caught["inputs"], run_s=run_s,
        pool_s=pool_s)


def cp_inerf_frame(config, params, mask, dev):
    """The CP iNeRF case: lego's camera, a true pose, the 800x800 frame
    rendered from the field there and the JAX test's perturbed start ->
    (cam_k, gt, obs, start)."""
    cam_k = lego_camera()
    gt = _look_at_c2w(4.0 * np.array([math.cos(0.6) * math.cos(0.5),
                                      math.sin(0.6) * math.cos(0.5),
                                      math.sin(0.5)]))
    obs = render_rgba(config, params, mask, gt, cam_k, dev)
    return cam_k, gt, obs, perturbed(gt)


def cp_inerf(config, params, mask, frame, n_iters, seed, dev):
    """``n_iters`` iterations of ``estimate_pose_inerf`` at
    test_pose_estimation's settings from ``cp_inerf_frame``'s start ->
    (loss, pose, history)."""
    cam_k, _, obs, start = frame
    return estimate_pose_inerf(
        start, obs, cam_k, config, params, mask, sampling_strategy="random",
        lrate=INERF_LRATE, batch_size=INERF_BATCH, color_bkgd_aug="random",
        n_iters=n_iters, dice_loss=True, seed=seed, device=dev)


def phase_tensor_cp(dev):
    """TensorCP fields on the card: ``train_cp`` (its checks: the CP kernels
    and K3's mask lookup every step, every forward on the shared-memory
    route, no texel lerp in torch, no VM kernel, the events, a final grid
    of about 500^3, finite and changing losses);
    the three CP kernels held to their plain versions and timed at the
    final step's samples and at a colour chunk of ``explore_field``, K3's
    backward at the mask's and the lines' shapes; a step's split and
    profile; the samplers' route under grad beside the kernels'
    (``cp_sampler_route``); ``explore_field`` on the trained field (launch
    counts, no texel lerp in torch); CP_INERF_ITERS iterations of
    ``estimate_pose_inerf`` from the JAX test's perturbation of an 800x800
    frame rendered from the field, INERF_PROFILE_ITERS more under the
    profiler; the coordinate kernel and the forward
    held to their plain versions at an iteration's inputs, the coordinate
    kernel also at an all-live set of as many samples (``cp_all_live_
    inputs``), repeats bit-equal at both -> {kernel: the kernels line's
    entry}."""
    t_phase = time.perf_counter()
    run = train_cp(dev)
    args, config, params, mask = run.args, run.config, run.params, run.mask
    steps, counts = run.steps, run.counts
    check(len(steps) == FT_ITERS, f"{len(steps)} steps")
    check(counts["cp_features"] > 0
          and counts["cp_features_backward"] == FT_ITERS
          and counts["gather_rows"] > 0,
          f"the run launched cp_features, its backward and K3: {counts}")
    check(counts["field_features"] == 0 and counts["banked_scores"] == 0
          and counts["fused_ray_scores"] == 0
          and counts["gather_rows_backward"] == 0,
          f"a CP run launches no VM, scoring or K3-backward kernel: {counts}")
    check(run.torch_lerps == 0, f"{run.torch_lerps} texel lerps in torch")
    check(counts["cp_features_shared"] == counts["cp_features"]
          and counts["cp_features_l1"] == 0,
          f"the CP training's forwards take the shared-memory route: {counts}")
    kinds = [e["event"] for e in run.events]
    check(kinds == ["alpha-mask update + shrink", "upsample",
                    "alpha-mask update + ray filtering", "upsample"],
          f"the phase events {kinds}")
    grid = tuple(config.grid_size)
    check(math.prod(grid) > 0.9 * args.N_voxel_final, f"final grid {grid}")
    mses = [st["mse"] for st in steps]
    check(all(math.isfinite(x) for x in mses), f"finite losses {mses}")
    check(all(a != b for a, b in zip(mses, mses[1:])),
          f"the loss changes from step to step {mses}")
    check(all(bool(torch.isfinite(a).all()) for a in leaves(params)),
          "finite trained parameters")
    n_final = cal_n_samples(config.grid_size, args.step_ratio)

    # the kernels at the final step's samples
    p, xyz, dsigma, dapp = run.caught
    run.caught = None
    check(xyz.shape[0] == FT_BATCH * n_final,
          f"the final step's samples ({xyz.shape[0]})")
    at_step = cp_kernel_holds(config, p, xyz, dsigma, dapp, "the final step")
    g = torch.Generator(device=dev).manual_seed(SEED + 61)
    vol = mask.volume
    mask_idx = corners_3d(*vol.shape, xyz)[0].reshape(-1).contiguous()
    k3_step = k3_backward_holds(
        vol.numel(), mask_idx,
        torch.randn((mask_idx.shape[0], 1), generator=g, device=dev),
        "the mask's shape at the final step")
    del mask_idx
    line_idx = corners_1d(grid[2], xyz[:, VEC_MODE[0]])[0].reshape(-1)
    k3_line = k3_backward_holds(
        grid[2], line_idx.contiguous(),
        torch.randn((line_idx.shape[0], 96), generator=g, device=dev),
        "a density line at the final step")
    del p, xyz, dsigma, dapp, line_idx
    torch.cuda.empty_cache()

    split = step_split_field(config, params, mask, run.pool, n_final, dev,
                             weights={"l1": 1e-5, "tv_d": 0.0, "tv_a": 0.0})
    sampler_counts, sampler_route = cp_sampler_route(
        config, params, mask, run.pool, n_final, dev)
    del run.pool
    torch.cuda.empty_cache()

    # explore_field on the trained CP field
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    with count_torch_lerps() as torch_lerps, captured_cp(
            "_launch_forward", lambda dims, flat: dims[4] > 0
            and flat.shape[0] == CHUNK_SAMPLES) as chunk:
        _reset_counts()
        t0 = time.perf_counter()
        ori, dirs, rgb = explore_field(
            gen, config, params, mask, gen_points=GEN_POINTS,
            n_iteration=N_EPOCHS, max_resampling_iterations=MAX_RESAMPLING)
        explore_s = _sync_s(t0)
        explore_counts = _counts()
    explore_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = GEN_POINTS * N_ISOCELL
    for name, a in (("ori", ori), ("dirs", dirs), ("rgb", rgb)):
        check(a.shape == (n, 3) and bool(torch.isfinite(a).all()),
              f"explore_field {name} on the CP field")
    check(explore_counts["cp_features"] > 0
          and explore_counts["cp_features_shared"] == explore_counts["cp_features"]
          and explore_counts["field_features"] == 0
          and torch_lerps["n"] == 0,
          f"explore_field on the CP field: {explore_counts}, "
          f"{torch_lerps['n']} torch lerps")
    del ori, dirs, rgb
    cp, cxyz, _, _ = chunk["inputs"]
    at_chunk = cp_kernel_holds(config, cp, cxyz,
                               *cp_random_upstream(cp, cxyz, SEED + 62),
                               "a colour chunk")
    line_idx = corners_1d(grid[2], cxyz[:, VEC_MODE[0]])[0].reshape(-1)
    k3_chunk = k3_backward_holds(
        grid[2], line_idx.contiguous(),
        torch.randn((line_idx.shape[0], 288), generator=g, device=dev),
        "an appearance line at a colour chunk")
    plane_idx = corners_2d(K3_PLANE, K3_PLANE, cxyz[:, :2])[0].reshape(-1)
    k3_plane = k3_backward_holds(
        K3_PLANE ** 2, plane_idx.contiguous(),
        torch.randn((plane_idx.shape[0], 48), generator=g, device=dev),
        "a VM plane at a colour chunk")
    del cp, cxyz, line_idx, plane_idx

    # iNeRF on the CP field
    t0 = time.perf_counter()
    frame = cp_inerf_frame(config, params, mask, dev)
    render_s = _sync_s(t0)
    gt, obs, start = frame[1:]
    check(bool(torch.isfinite(obs).all()), "finite CP frame")
    coverage = float((obs[..., 3] > 0.5).float().mean())
    with count_torch_lerps() as torch_lerps, captured_cp(
            "_launch_coords_grad", first_call()) as caught, captured_cp(
            "_launch_forward", first_call()) as fcaught:
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, refined, _ = cp_inerf(config, params, mask, frame,
                                    CP_INERF_ITERS, SEED, dev)
        inerf_s = _sync_s(t0)
        inerf_counts = _counts()
    inerf_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(inerf_counts["cp_features"] == CP_INERF_ITERS
          and inerf_counts["cp_features_shared"] == CP_INERF_ITERS
          and inerf_counts["cp_features_coords_grad"] == CP_INERF_ITERS
          and inerf_counts["cp_features_backward"] == 0
          and torch_lerps["n"] == 0,
          f"an iNeRF iteration on the CP field: one forward and one "
          f"coordinate launch, no line backward: {inerf_counts}")
    check(math.isfinite(float(loss)) and bool(np.isfinite(refined).all()),
          f"finite iNeRF result {loss}")

    def some_iterations():
        cp_inerf(config, params, mask, frame, INERF_PROFILE_ITERS, SEED + 1,
                 dev)
        return INERF_PROFILE_ITERS

    inerf_profile = _profiled("tensor_cp_inerf_iteration", some_iterations)
    ip, ixyz, ids, ida = caught["inputs"]
    it_coords = cp_coords_holds(config, ip, ixyz, ids, ida,
                                "an iNeRF iteration")
    all_live = cp_coords_holds(config, *cp_all_live_inputs(ip, dev),
                               "the CP all-live set")
    del ip, ixyz, ids, ida
    fp, fxyz, _, _ = fcaught["inputs"]
    it_forward = cp_forward_holds(config, fp, fxyz, "an iNeRF iteration")
    del fp, fxyz

    emit(phase="tensor_cp", flags=list(CP_FLAGS), iters=FT_ITERS,
         events_at=FT_EVENTS, batch=FT_BATCH, pool_s=run.pool_s,
         final_grid=list(grid), final_aabb=[list(a) for a in config.aabb],
         n_samples=n_final, run_s=run.run_s,
         step_s=[st["s"] for st in steps], mse=mses,
         steps_by_grid=steps_by_grid(steps), phase_events=run.events,
         split=split, peak_mem_gb=max(st["peak_mem_gb"] for st in steps),
         launches=counts, kernels_at_step=at_step,
         kernels_at_colour_chunk=at_chunk,
         k3_backward={"mask_at_step": k3_step, "density_line_at_step": k3_line,
                      "app_line_at_colour_chunk": k3_chunk,
                      "vm_plane_at_colour_chunk": k3_plane},
         grad_tolerance=CP_GRAD_TOL, sampler_route=sampler_route,
         sampler_launches=sampler_counts,
         explore={"s": explore_s, "launches": explore_counts,
                  "torch_lerps": 0, "peak_mem_gb": explore_peak},
         inerf={"iters": CP_INERF_ITERS, "s": inerf_s,
                "ms_per_iteration": 1e3 * inerf_s / CP_INERF_ITERS,
                "render_s": render_s, "coverage": coverage,
                "loss": float(loss),
                "errors_start": pose_errors(gt, start),
                "errors_end": pose_errors(gt, refined),
                "launches": inerf_counts, "peak_mem_gb": inerf_peak,
                "profile": inerf_profile,
                "coords_grad_at_iteration": it_coords,
                "coords_grad_all_live": all_live,
                "forward_at_iteration": it_forward},
         phase_s=time.perf_counter() - t_phase)
    by_path = {"tensor_cp_train": counts, "tensor_cp_explore": explore_counts,
               "tensor_cp_inerf": inerf_counts,
               "tensor_cp_samplers": sampler_counts}

    def entry(name, kernel, path, design, **extra):
        step, chunk_row = at_step[kernel], at_chunk[kernel]
        return dict(
            name=name, route="cuda",
            source="iffnerf_tpu_torch/csrc/cp_features.cu",
            replaces="iffnerf_tpu/models/field.py:383",
            replaces_kind="no pallas_call: the CP field's texel fetches"
                          " (pallas_gather's work, extra/pallas_gather_bench"
                          ".py:46) and their lerps and products"
                          " (iffnerf_tpu/models/field.py:383-389,484-489),"
                          " differentiated by XLA",
            design=design,
            launches=by_path[path][name],
            launches_by_path={k: c[name] for k, c in by_path.items()},
            max_abs_err=step["max_abs_err"],
            ms=step["ms"], eager_ms=step["eager_ms"],
            plain_ms=step["plain_ms"], bound_ms=step["bound_ms"],
            bound_by=step["bound_by"], library_ms=step["library_ms"],
            library="F.grid_sample on the three lines"
                    + (" (backward)" if kernel != "forward" else "")
                    + ", in chunks of 2^20 samples",
            at_colour_chunk=chunk_row, at_step=step, **extra)

    k3 = dict(
        name="gather_rows.backward", route="cuda",
        source="iffnerf_tpu_torch/csrc/gather_rows.cu",
        replaces="extra/pallas_gather_bench.py:46",
        replaces_kind="the backward of pallas_gather's work (jnp.take's"
                      " scatter-add, which XLA derives)",
        design="backward_plan's launch: column slices of at most 96; each"
               " block of a slice walks a span of units of consecutive"
               " entries, its warps taking units from a shared-memory"
               " counter, groups of lanes holding consecutive entries' words"
               " loaded steps ahead; runs of equal rows merged by a segmented"
               " shuffle scan and carried from step to step, one RED a run"
               " and word into device memory",
        launches=sampler_counts["gather_rows_backward"],
        launches_by_path={k: c["gather_rows_backward"]
                          for k, c in by_path.items()},
        max_abs_err=k3_step["max_abs_err"],
        **{k: k3_step[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms")},
        library="torch.Tensor.index_add_",
        at_density_line=k3_line, at_app_line_colour_chunk=k3_chunk,
        at_vm_plane_colour_chunk=k3_plane,
        at_sampler_step=sampler_route["k3_backward_launches"],
        sampler_step_sum=sampler_route["k3_backward_sum"])
    return [
        entry("cp_features", "forward", "tensor_cp_train",
              "shared route: one block an SM holds a slice of 32 ranks of"
              " the three lines in shared memory; its 16 warps walk 32-sample"
              " units in turn with every slice's, each lane computing one"
              " sample's corners into the warp's records (rows by slot"
              " parity, flagged weights), then groups of 4 lanes of 8 ranks"
              " each walk their samples, reading a slot's words from the"
              " slice only when its row changes, and store whole sectors"
              " evict-first; the density slices' sums added in slice order"
              " by a second kernel. Lines past the slice's room take the"
              " first design (a group of lanes a sample, rows through L1)",
              launches_by_route={
                  route: counts[f"cp_features_{route}"]
                  for route in cp_features.launches_by_route},
              launches_by_route_by_path={
                  k: {route: c[f"cp_features_{route}"]
                      for route in cp_features.launches_by_route}
                  for k, c in by_path.items()},
              at_inerf_iteration=it_forward),
        entry("cp_features_backward", "backward", "tensor_cp_train",
              "one block an SM owns a slice of up to 32 ranks and keeps that"
              " slice of all three lines' sums in shared memory; each of its"
              " 16 warps takes units of 1024 samples from the slice's queue,"
              " its lane 0 bulk-copying each 8-sample stage's dapp box (TMA),"
              " xyz and dsigma into the warp's 2-stage mbarrier ring; one vote"
              " a sample (dead stages left at once), corners computed once"
              " into the stage's box as rows by parity and weights, the line"
              " words of a stage loaded at once, a slot's terms merged in"
              " registers until its row changes; one float RED a row, rank"
              " and block"),
        entry("cp_features_coords_grad", "coords_grad", "tensor_cp_inerf",
              "one block an SM of 12 warps, each taking 64-sample units from"
              " a queue and streaming 8-sample stages (xyz, dsigma, whole dapp"
              " rows) through its own 2-stage bulk-copy mbarrier ring; one"
              " vote a sample (a dead stage stores zeros at once), corners"
              " once a block into records (slot keys by parity with the"
              " flags, the odd slot's weight, the signed axis factor); the"
              " live samples walked with three float4 words a lane and each"
              " axis's slot words in registers, reloaded only when a key"
              " changes; rank-order sums met by a fixed shuffle tree, no"
              " atomics",
              at_inerf_iteration=it_coords, at_all_live=all_live),
        k3]


# ---------------------------------------------------------------------------
# the data mesh: the sharded routes inside a one-rank NCCL group
# ---------------------------------------------------------------------------


def _params_agree(a, b, rtol=1e-4, atol=1e-6):
    """-> (largest |a - b| over the leaves, all within the rule, all
    bit-equal)."""
    fa, fb = (_flatten(_numpy_leaves(t)) for t in (a, b))
    worst = max(float(np.abs(fa[k] - fb[k]).max()) for k in fa)
    close = all(np.allclose(fa[k], fb[k], rtol=rtol, atol=atol) for k in fa)
    return worst, close, all(np.array_equal(fa[k], fb[k]) for k in fa)


def sharded_pose(mesh, params, cfg, imgs, mask, rays):
    """The sharded estimate at full width (bf16 bank) against the exact
    route (c2w within 1e-4, the same top-100) and K1's banked route
    (``_compare_routes``' rule), each timed over the same images; then
    ``test_pose_estimation`` with the mesh against without it."""
    ro, rd, rr = rays
    bank = ray_bank(params, cfg, ro, rd, rr)
    _reset_counts()
    outs, ms = _drive(lambda img: estimate_pose_single_sharded(
        params, cfg, img, mask, ro, rd, rr, UP, mesh, k=K_TOP, bank=bank),
        imgs)
    counts = _counts()
    check(counts["banked_scores"] == 0, f"the sharded estimate scores on "
          f"the exact route: {counts}")
    exact = dataclasses.replace(cfg, fused_bank=False)
    refs, exact_ms = _drive(lambda img: estimate_pose_single_banked(
        params, exact, img, mask, bank, ro, rd, UP, k=K_TOP), imgs)
    k1, k1_ms = _drive(lambda img: estimate_pose_single_banked(
        params, cfg, img, mask, bank, ro, rd, UP, k=K_TOP), imgs)
    vs_exact, ov_exact = _compare_routes(outs, refs, "sharded vs exact")
    vs_k1, ov_k1 = _compare_routes(outs, k1, "sharded vs K1")
    bit_equal = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                    for a, b in zip(outs, refs))
    del outs, refs, k1
    frames = synthetic_frames(imgs.device)
    rows, *_ = test_pose_estimation(frames, params, cfg, ro, rd, rr,
                                    torch.tensor(UP), mesh=mesh,
                                    log_fn=lambda *a: None)
    plain, *_ = test_pose_estimation(frames, params, cfg, ro, rd, rr,
                                     torch.tensor(UP), log_fn=lambda *a: None)
    tpe = max(float(np.abs(np.asarray(a["pred_c2w"])
                           - np.asarray(b["pred_c2w"])).max())
              for a, b in zip(rows, plain))
    check(len(rows) == N_FRAMES and tpe <= 1e-4, f"test_pose_estimation "
          f"with the mesh: {len(rows)} rows, c2w {tpe} from no mesh")
    return {"n_rays": N_RAYS, "images": imgs.shape[0], "launches": counts,
            "ms_per_image_median": statistics.median(ms), "ms_per_image": ms,
            "exact_route_ms_per_image_median": statistics.median(exact_ms),
            "k1_banked_ms_per_image_median": statistics.median(k1_ms),
            "c2w_max_diff_vs_exact": vs_exact,
            "top100_min_overlap_vs_exact": ov_exact,
            "bit_equal_to_exact": bit_equal,
            "c2w_max_diff_vs_k1": vs_k1, "top100_min_overlap_vs_k1": ov_k1,
            "test_pose_estimation_c2w_max_diff": tpe}


def sharded_render(mesh, field, field_mask, dev):
    """The per-object field rendered at lego's 800x800 camera from radius
    4, with the mesh and without, in turns (mesh, plain, plain, mesh): each
    with-mesh render's rgb and depth within SHARD_RENDER_ATOL of each
    plain one's; the seconds of each."""
    config, params = field
    unit, radii = _ray_grid(dev)
    c2w = torch.as_tensor(_look_at_c2w(np.array([2.4, -2.4, 2.0])),
                          device=dev)
    rays = torch.cat([c2w[:3, 3].expand(unit.shape[0], 3), unit @ c2w[:3, :3].T,
                      radii], -1)
    out = {"mesh": [], "plain": []}
    for name in ("mesh", "plain", "plain", "mesh"):
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rgb, depth = render_chunked(config, params, field_mask, rays,
                                    white_bg=True,
                                    mesh=mesh if name == "mesh" else None)
        out[name].append((rgb, depth, _sync_s(t0), _counts()))
    counts = out["mesh"][0][3]
    diff, bit_equal = 0.0, True
    for rgb, depth, _, _ in out["mesh"]:
        for rgb0, depth0, _, _ in out["plain"]:
            diff = max(diff, float((rgb - rgb0).abs().max()),
                       float((depth - depth0).abs().max()))
            bit_equal &= bool(torch.equal(rgb, rgb0)
                              and torch.equal(depth, depth0))
    check(diff <= SHARD_RENDER_ATOL, f"render with the mesh vs without: "
          f"{diff}")
    rgb = out["mesh"][0][0]
    check(bool(torch.isfinite(rgb).all()) and bool((rgb < 0.99).any()),
          "the render shows the field")
    check(counts["field_features"] > 0 and counts["gather_rows"] > 0,
          f"the sharded render launched field_features and K3: {counts}")
    return {"rays": rays.shape[0], "launches": counts,
            "seconds": [r[2] for r in out["mesh"]],
            "plain_seconds": [r[2] for r in out["plain"]],
            "max_abs_diff": diff, "bit_equal": bit_equal}


def sharded_train(dev):
    """SHARD_STEPS steps of configs/lego.txt through ``train_field`` with
    ``--data_mesh 1`` and ``0`` from one 128^3 field and seed, in turns
    (plain, mesh, mesh, plain); each step timed; every with-mesh run's
    parameters held to every plain run's under the CPU tests' training
    rule."""
    WORK_DIR.mkdir(parents=True, exist_ok=True)
    pool = synthetic_ray_pool(dev, SHARD_POOL, SEED + 30)
    path = WORK_DIR / "sharded_field_128.npz"
    base = config_args("lego", SHARD_STEPS, (), ())
    cfg0, np_params, mask0 = make_lego_field(dev, FT_GRID_INIT, spread=1.75)
    save_field(str(path), field_config_from_args(
        base, pool.scene_bbox, (FT_GRID_INIT,) * 3, pool.near_far),
        np_params, mask0)
    del np_params, mask0
    runs = {"mesh": [], "plain": []}
    for name in ("plain", "mesh", "mesh", "plain"):
        args = config_args("lego", SHARD_STEPS, (), (),
                           extra=("--data_mesh", "1" if name == "mesh" else "0"))
        config, params, mask = load_field(str(path), device=dev)
        with timed_field_steps() as steps:
            _reset_counts()
            _, params, _ = train_field(
                args, config, params, mask, pool, None,
                str(WORK_DIR / f"sharded_train_{name}"),
                log_fn=lambda *a: None, device=dev,
                reso_cur=N_to_reso(args.N_voxel_init, pool.scene_bbox))
            counts = _counts()
        runs[name].append((params, steps, counts))
    path.unlink()
    worst, close, bit_equal = 0.0, True, True
    for params, _, _ in runs["mesh"]:
        for params0, _, _ in runs["plain"]:
            w, c, b = _params_agree(params, params0)
            worst, close, bit_equal = max(worst, w), close and c, bit_equal and b
    check(close, f"--data_mesh 1 and 0 agree after {SHARD_STEPS} steps "
          f"({worst})")
    counts = runs["mesh"][0][2]
    check(counts["field_features"] > 0 and counts["field_features_backward"]
          == SHARD_STEPS and counts["gather_rows"] > 0,
          f"the sharded steps launched field_features, its backward and "
          f"K3: {counts}")
    return {"steps": SHARD_STEPS, "batch": FT_BATCH, "grid": FT_GRID_INIT,
            "pool_frames": SHARD_POOL, "launches": counts,
            "step_s": [[st["s"] for st in r[1]] for r in runs["mesh"]],
            "plain_step_s": [[st["s"] for st in r[1]] for r in runs["plain"]],
            "mse": [[st["mse"] for st in r[1]] for r in runs["mesh"]],
            "plain_mse": [[st["mse"] for st in r[1]] for r in runs["plain"]],
            "params_max_abs_diff": worst, "params_bit_equal": bit_equal}


def phase_sharded(params, cfg, imgs, mask, rays, field, field_mask, dev):
    """The sharded routes through the entry points inside a one-rank NCCL
    group (a ``file://`` rendezvous in a temporary directory; the group is
    destroyed at the end): the pose estimate, the render, field training.
    Launch counts set to 0 just before each and read just after. -> the
    counts by route."""
    import tempfile

    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                                rank=0, world_size=1)
        try:
            mesh = make_mesh()
            check(mesh.size == 1 and mesh.device.type == "cuda",
                  f"a one-rank mesh on the card: {mesh}")
            pose = sharded_pose(mesh, params, cfg, imgs, mask, rays)
            render = sharded_render(mesh, field, field_mask, dev)
            train = sharded_train(dev)
        finally:
            dist.destroy_process_group()
    emit(phase="sharded", backend="nccl", ranks=1, pose=pose, render=render,
         train=train)
    return {"sharded_pose": pose["launches"],
            "sharded_render": render["launches"],
            "sharded_train": train["launches"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = resolve_device("cuda")
    phase_device()

    cfg16 = IDConfig(compute_dtype="bfloat16")
    cfg32 = IDConfig()
    params = init_id_module(torch.Generator().manual_seed(SEED), cfg16,
                            device=dev)
    ro, rd, rr, imgs, mask = make_scene(dev)
    rays = (ro, rd, rr)
    img0 = imgs[0]

    k1_errs = phase_banked_kernel(params, (cfg32, cfg16), img0, mask, rays)
    k2_errs = phase_fused_kernel(params, (cfg32, cfg16), img0, mask, rays)
    k3_err = phase_gather_kernel(dev)
    phase_guards(params, cfg16, img0, mask, rays)
    k1_counts, banked_ms = phase_banked_estimate(params, cfg16, imgs, mask, rays)
    # the pose CLI's --pose_f32 route: a float32 bank through K1's TF32 route
    k1f32_counts, banked32_ms = phase_banked_estimate(
        params, cfg32, imgs[:N_WARM + 3], mask, rays)
    k2_counts, fused_ms = phase_fused_estimate(params, cfg16, imgs, mask, rays)
    # the unbanked route in float32: K2's three-TF32 route every image
    k2f32_counts, fused32_ms = phase_fused_estimate(
        params, cfg32, imgs[:N_WARM + 3], mask, rays)
    obj_counts, field, field_mask, chunk_coords = phase_object(params, cfg16,
                                                               dev)
    ff_err = phase_field_kernel(field, chunk_coords, dev)
    rows = phase_times(params, (cfg16, cfg32), img0, mask, rays, field,
                       chunk_coords)
    del chunk_coords
    bank = ray_bank(params, cfg16, ro, rd, rr)
    bank32 = ray_bank(params, cfg32, ro, rd, rr)
    fused16 = IDConfig(compute_dtype="bfloat16", fused_scoring=True)
    fused32 = IDConfig(fused_scoring=True)
    phase_profile({
        "banked": lambda img: estimate_pose_single_banked(
            params, cfg16, img, mask, bank, ro, rd, UP, k=K_TOP),
        "banked_float32": lambda img: estimate_pose_single_banked(
            params, cfg32, img, mask, bank32, ro, rd, UP, k=K_TOP),
        "fused": lambda img: estimate_pose_single(
            params, fused16, img, mask, ro, rd, rr, UP, k=K_TOP),
        "fused_float32": lambda img: estimate_pose_single(
            params, fused32, img, mask, ro, rd, rr, UP, k=K_TOP)}, imgs)
    del bank, bank32
    torch.cuda.empty_cache()
    # the data mesh in a one-rank NCCL group: the sharded estimate on the
    # exact route, the render (field_features, K3) and field training
    # (field_features and its backward, K3)
    sh_counts = phase_sharded(params, cfg16, imgs, mask, rays, field,
                              field_mask, dev)
    torch.cuda.empty_cache()
    # ID-module training: its renewals launch K3 and field_features
    id_counts = phase_id_train(field, field_mask, dev)
    del field, field_mask
    torch.cuda.empty_cache()
    # TensoRF training: field_features and its backward every step, K3's
    # mask lookup every step
    ft_counts, ft_backward, ft_forward = phase_field_train(dev)
    torch.cuda.empty_cache()
    # real scenes: flower on NDC rays through its schedule, bicycle at its
    # final grid; field_features and its backward every step, K3 every
    # step after flower's mask update
    real = phase_real_scenes(dev)
    # object captures: co3d through its schedule and its mesh, repair at
    # its final grid, the unisphere contraction; field_features and its
    # backward every step, K3 after co3d's mask update, the density-only
    # field_features over the mesh's lattice
    captures = phase_object_captures(dev)
    rs_counts = {name: r[0] for name, r in real.items()}
    rs_counts.update({f"object_captures_{name}": r[0]
                      for name, r in captures.items()})
    trained = {name: r for name, r in captures.items() if r[1] is not None}
    torch.cuda.empty_cache()
    # TensorCP: the CP kernels every step, K3's mask lookup after the first
    # mask update, K3's backward on the samplers' route, the coordinate
    # kernel every iNeRF iteration
    cp_entries = phase_tensor_cp(dev)
    torch.cuda.empty_cache()
    # iNeRF refinement: field_features, its coordinate kernel and K3's mask
    # lookup every iteration
    inerf_counts, coords_entry = phase_inerf(params, cfg16, rays, dev)

    n_est = N_WARM + N_TIMED
    kernels = [
        dict(name="banked_scores", route="cuda",
             source="iffnerf_tpu_torch/csrc/banked_attention.cu",
             replaces="iffnerf_tpu/ops/banked_attention.py:97",
             design="bf16: persistent warp-specialised passes on 2-CTA"
                    " clusters, TMA multicast into a 16-chunk mbarrier"
                    " ring, wgmma m64n128k16",
             launches=k1_counts["banked_scores"],
             launches_per_estimate=k1_counts["banked_scores"] / n_est,
             max_abs_err=k1_errs[f"bfloat16/{N_RAYS}"]["max_abs_err"],
             **rows["banked_scores/bfloat16"],
             float32=dict(
                 design="persistent warp-specialised passes on 4-CTA"
                        " clusters, TMA multicast into two 2-chunk mbarrier"
                        " rings, three TF32 wgmma m64n64k8 a step (A split"
                        " in registers, q_hi and q_lo in shared memory)",
                 launches=k1f32_counts["banked_scores"],
                 launches_per_estimate=(k1f32_counts["banked_scores"]
                                        / (N_WARM + 3)),
                 max_abs_err=k1_errs[f"float32/{N_RAYS}"]["max_abs_err"],
                 estimate_ms_per_image=banked32_ms,
                 **rows["banked_scores/float32"])),
        dict(name="fused_ray_scores", route="cuda",
             source="iffnerf_tpu_torch/csrc/fused_ray_attention.cu",
             replaces="iffnerf_tpu/ops/fused_ray_attention.py:90",
             design="bf16: one persistent warp-specialised CTA an SM, the"
                    " weights' 16-deep steps bulk-copied four a stage into a"
                    " 3-stage mbarrier ring, bf16 wgmma m64nNk16 with both"
                    " operands in shared memory, two warpgroups splitting"
                    " each layer's columns",
             launches=k2_counts["fused_ray_scores"],
             launches_per_estimate=k2_counts["fused_ray_scores"] / n_est,
             max_abs_err=k2_errs[f"bfloat16/{N_RAYS}"]["max_abs_err"],
             **rows["fused_ray_scores/bfloat16"],
             float32=dict(
                 design="one persistent warp-specialised CTA an SM, the"
                        " weights' TF32-split steps bulk-copied into a"
                        " 5-stage mbarrier ring, the"
                        " activations in shared memory, three TF32 wgmma"
                        " m64nNk8 a step (A split in registers), two"
                        " warpgroups splitting each layer's columns",
                 launches=k2f32_counts["fused_ray_scores"],
                 launches_per_estimate=(k2f32_counts["fused_ray_scores"]
                                        / (N_WARM + 3)),
                 max_abs_err=k2_errs[f"float32/{N_RAYS}"]["max_abs_err"],
                 max_rel_err=k2_errs[f"float32/{N_RAYS}"]["max_rel_err"],
                 estimate_ms_per_image=fused32_ms,
                 **rows["fused_ray_scores/float32"])),
        dict(name="gather_rows", route="cuda",
             source="iffnerf_tpu_torch/csrc/gather_rows.cu",
             replaces="extra/pallas_gather_bench.py:46",
             launches=obj_counts["gather_rows"], max_abs_err=k3_err,
             launches_by_path={"object": obj_counts["gather_rows"],
                               "id_train": id_counts["gather_rows"],
                               "field_train": ft_counts["gather_rows"],
                               **{(k if k.startswith("object_")
                                   else f"real_scenes_{k}"): c["gather_rows"]
                                  for k, c in rs_counts.items()},
                               "inerf": inerf_counts["gather_rows"],
                               **{k: c["gather_rows"]
                                  for k, c in sh_counts.items()}},
             **rows["gather_rows/mask_stacked"]),
        dict(name="field_features", route="cuda",
             source="iffnerf_tpu_torch/csrc/field_features.cu",
             replaces="extra/pallas_gather_bench.py:46",
             design_of="compute_features_fused (iffnerf_tpu/models/field.py:394):"
                       " the work pallas_gather served, its gather fused with"
                       " the lerps",
             design="a cell pass leaves each sample's slot weights and the"
                    " rows its cell enters in shared memory; then a group of"
                    " lanes (a word of one axis pair each) walks a run of up"
                    " to 32 consecutive samples, keeps its cell's 4 plane and"
                    " 2 line corner words in registers in slots by parity,"
                    " reads only the corners a cell enters and stores the"
                    " products under L2's evict-first policy; density sums"
                    " meet in shared memory in a fixed order; the host"
                    " shortens runs for small calls",
             launches=obj_counts["field_features"], max_abs_err=ff_err,
             ms_grid_128=ft_forward["checks"]["grid_128"]["ms"],
             ms_grid_final=ft_forward["checks"]["grid_final"]["ms"],
             ms_axis_rays=ft_forward["checks"]["axis_rays"]["ms"],
             launches_by_path={"object": obj_counts["field_features"],
                               "id_train": id_counts["field_features"],
                               "field_train": ft_counts["field_features"],
                               **{(k if k.startswith("object_")
                                   else f"real_scenes_{k}"):
                                  c["field_features"]
                                  for k, c in rs_counts.items()},
                               "inerf": inerf_counts["field_features"],
                               **{k: c["field_features"]
                                  for k, c in sh_counts.items()}},
             at_training_step=ft_forward,
             at_real_scenes={k: r[1] for k, r in real.items()},
             at_object_captures={k: r[1] for k, r in trained.items()},
             **rows["field_features/colour_chunk/both"]),
        dict(ft_backward,
             launches_by_path=dict(
                 ft_backward["launches_by_path"],
                 **{(k if k.startswith("object_") else f"real_scenes_{k}"):
                    c["field_features_backward"]
                    for k, c in rs_counts.items()},
                 sharded_train=sh_counts["sharded_train"][
                     "field_features_backward"]),
             at_real_scenes={k: r[2] for k, r in real.items()},
             at_object_captures={k: r[2] for k, r in trained.items()}),
        dict(coords_entry, launches_by_path=dict(
            coords_entry["launches_by_path"],
            **{k: c["field_features_coords_grad"]
               for k, c in rs_counts.items() if k.startswith("object_")})),
        *cp_entries,
    ]
    emit(phase="latency", banked_ms_per_image=banked_ms,
         banked_float32_ms_per_image=banked32_ms, fused_ms_per_image=fused_ms,
         fused_float32_ms_per_image=fused32_ms)
    print(card_line(), flush=True)
    emit(kernels=kernels)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
