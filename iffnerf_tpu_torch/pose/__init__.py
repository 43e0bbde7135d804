"""Single-image pose estimation against a per-object ray bank."""

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
    init_id_module,
    ray_bank,
    run_attention,
    test_image,
)
from iffnerf_tpu_torch.pose.solve import (
    estimate_pose_single,
    estimate_pose_single_banked,
    solve_pose_from_topk,
)
from iffnerf_tpu_torch.pose.vit import ViTConfig
