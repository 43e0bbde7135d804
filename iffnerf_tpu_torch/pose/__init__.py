"""Pose pipeline: the object side (surface sampling, isocell rays), the
ID-module trainer and the single-image estimate against a per-object ray
bank."""

from iffnerf_tpu_torch.pose.geometry import (
    compute_angular_error,
    compute_line_intersection,
    compute_line_intersection_impl2,
    compute_line_intersection_impl3,
    compute_line_intersection_impl4,
    compute_translation_error,
    exclude_negatives,
    make_rotation_mat,
)
from iffnerf_tpu_torch.pose.id_module import (
    IDConfig,
    distance_based_score_loss,
    init_id_module,
    ray_bank,
    run_attention,
    test_image,
)
from iffnerf_tpu_torch.pose.isocell import isocell_distribution, rotate_isocell
from iffnerf_tpu_torch.pose.sampling import (
    explore_field,
    generate_all_possible_rays,
    iterative_surface_sampling_process,
    samples_points_normals,
)
from iffnerf_tpu_torch.pose.solve import (
    estimate_pose_single,
    estimate_pose_single_banked,
    solve_pose_from_topk,
)
from iffnerf_tpu_torch.pose.test import test_pose_estimation
from iffnerf_tpu_torch.pose.trainer import (
    id_train_step,
    make_id_optimizer,
    train_id_module,
)
from iffnerf_tpu_torch.pose.vit import ViTConfig
