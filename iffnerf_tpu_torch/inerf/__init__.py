"""iNeRF iterative pose-refinement baseline (reference inerf/; the JAX
package's ``iffnerf_tpu/inerf``)."""

from iffnerf_tpu_torch.inerf.estimate import (
    camera_transfer,
    estimate_pose_inerf,
    find_poi,
    soft_dice_loss,
)
