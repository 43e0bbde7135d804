"""Frozen-field loading for the pose pipeline
(reference pose_estimation/model_utils.py:4-33)."""

from __future__ import annotations

from iffnerf_tpu_torch.checkpoint import load_field, load_torch_checkpoint


def load_model(checkpoint_path: str, device=None):
    """A TensoRF field from the JAX package's ``.npz`` or a reference
    ``.th`` checkpoint -> (config, params, mask), the tensors on ``device``
    (CUDA unless ``device="cpu"``)."""
    if checkpoint_path.endswith(".th"):
        return load_torch_checkpoint(checkpoint_path, device=device)
    return load_field(checkpoint_path, device=device)
