"""Tensor-factorized radiance fields (TensorVMSplit / TensorCP), inference
(reference models/tensoRF.py:151-443, models/tensorBase.py:262-773).

A frozen ``FieldConfig`` carries the static description (grid, ranks,
AABB, derived step size and sample counts); parameters are a dict of
tensors in the JAX package's layout: planes ``[H, W, R]``, lines
``[L, R]``, Linear weights ``[in, out]``. Axis conventions follow the
reference (tensorBase.py:311-312): ``MAT_MODE = ((0,1),(0,2),(1,2))``,
``VEC_MODE = (2,1,0)`` -- plane ``i`` is indexed by (x=xyz[m0],
y=xyz[m1]) and line ``i`` by xyz[vec].

Features are evaluated densely through the grid samplers, whose texel
fetches run on the row-gather kernel (``ops/gather.py``). The footprint
packing, the compaction ladder and the grouped bit-row mask gate of the
JAX package work around the TPU's gather row rate and are not ported;
their ``FieldConfig`` fields are kept so that ``config_json`` round-trips.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from iffnerf_tpu_torch.nn import linear_apply
from iffnerf_tpu_torch.ops.grid_sample import (
    grid_sample_1d,
    grid_sample_2d,
    grid_sample_3d,
)

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    """Static field description (reference TensorBase.__init__ kwargs +
    get_kwargs, tensorBase.py:263-422)."""

    model_name: str = "TensorVMSplit"
    aabb: tuple = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
    grid_size: tuple = (128, 128, 128)
    density_n_comp: tuple = (16, 16, 16)
    app_n_comp: tuple = (48, 48, 48)
    app_dim: int = 27
    shading_mode: str = "MLP_PE"
    near_far: tuple = (2.0, 6.0)
    density_shift: float = -10.0
    alpha_mask_thres: float = 0.001
    distance_scale: float = 25.0
    ray_march_weight_thres: float = 0.0001
    pos_pe: int = 6
    view_pe: int = 6
    fea_pe: int = 6
    feature_c: int = 128
    step_ratio: float = 2.0
    fea2dense_act: str = "softplus"
    contraction_type: str = "aabb"
    step_size_bg: float = 0.1
    # TPU evaluation settings of the JAX package, read by nothing here
    fused_eval: str = "auto"
    compact_ratio: float = 0.25
    compact_ratio_unmasked: float = 0.0
    compact_ratio_eval: float = 0.125
    compact_ratios_eval: tuple = (0.125, 0.1875, 0.25, 0.375, 0.5, 0.75)
    mask_gate_group: int = 0

    # --- derived statics (reference update_stepSize, tensorBase.py:354-375) ---

    @property
    def aabb_np(self) -> np.ndarray:
        return np.asarray(self.aabb, dtype=np.float32)

    @property
    def aabb_size(self) -> np.ndarray:
        return self.aabb_np[1] - self.aabb_np[0]

    @property
    def units(self) -> np.ndarray:
        gs = np.asarray(self.grid_size, dtype=np.float32)
        if self.contraction_type == "unisphere":
            gs = gs * 0.5
        return self.aabb_size / (gs - 1.0)

    @property
    def step_size(self) -> float:
        return float(np.mean(self.units) * self.step_ratio)

    @property
    def aabb_diag(self) -> float:
        return float(np.sqrt(np.sum(np.square(self.aabb_size))))

    @property
    def n_samples(self) -> int:
        return int(self.aabb_diag / self.step_size) + 1

    @property
    def n_samples_bg(self) -> int:
        if self.contraction_type == "unisphere":
            near, far = self.near_far
            return int((far - near) / self.step_size_bg)
        return 0


@dataclasses.dataclass(frozen=True)
class AlphaMask:
    """Binary occupancy grid (reference AlphaGridMask, tensorBase.py:50-83):
    ``volume`` [D, H, W] (z, y, x-major) float32, sampled trilinearly;
    ``aabb`` [2, 3] the box it was built over; ``unisphere`` applies the
    Zip-NeRF power transform instead of the AABB normalization."""

    volume: torch.Tensor
    aabb: torch.Tensor
    unisphere: bool = False


def make_alpha_mask(volume: torch.Tensor, aabb,
                    contraction_type: str = "aabb") -> AlphaMask:
    return AlphaMask(
        volume=volume,
        aabb=torch.as_tensor(np.asarray(aabb, np.float32), device=volume.device),
        unisphere=contraction_type == "unisphere",
    )


def power_transformation(centered_xyz: torch.Tensor, alpha: float = -1.5):
    """Zip-NeRF power contraction (reference utils.py:139-147)."""
    x_abs = torch.abs(centered_xyz)
    negate_alpha = math.fabs(alpha - 1)
    return (torch.sign(centered_xyz) * (negate_alpha / alpha)
            * (torch.pow(x_abs / negate_alpha + 1.0, alpha) - 1.0))


def sample_alpha(mask: AlphaMask, xyz: torch.Tensor) -> torch.Tensor:
    """Trilinear alpha-mask lookup at world coords xyz [..., 3] -> [...]."""
    if mask.unisphere:
        center = (mask.aabb[0] + mask.aabb[1]) / 2.0
        coords = power_transformation(xyz - center, alpha=-1.5)
    else:
        inv_size = 2.0 / (mask.aabb[1] - mask.aabb[0])
        coords = (xyz - mask.aabb[0]) * inv_size - 1.0
    return grid_sample_3d(mask.volume, coords)


def normalize_coord(config: FieldConfig, xyz: torch.Tensor) -> torch.Tensor:
    """World -> [-1, 1] grid coords (reference tensorBase.py:389-397)."""
    aabb = torch.as_tensor(config.aabb_np, device=xyz.device)
    if config.contraction_type == "unisphere":
        center = (aabb[0] + aabb[1]) / 2.0
        return power_transformation(xyz - center, alpha=-1.5)
    inv_size = 2.0 / (aabb[1] - aabb[0])
    return (xyz - aabb[0]) * inv_size - 1.0


def feature2density(config: FieldConfig, features: torch.Tensor) -> torch.Tensor:
    """Density activation (reference tensorBase.py:750-754)."""
    if config.fea2dense_act == "softplus":
        return F.softplus(features + config.density_shift)
    if config.fea2dense_act == "relu":
        return torch.relu(features)
    raise ValueError(config.fea2dense_act)


def _plane_coords(xyz, i):
    m0, m1 = MAT_MODE[i]
    return torch.stack([xyz[..., m0], xyz[..., m1]], dim=-1)


def compute_densityfeature(config: FieldConfig, params,
                           xyz: torch.Tensor) -> torch.Tensor:
    """sigma feature at normalized coords xyz [..., 3] -> [...]
    (reference tensoRF.py:216-235 VM / :344-359 CP)."""
    if config.model_name == "TensorVMSplit":
        sigma = None
        for i in range(3):
            plane_feat = grid_sample_2d(params["density_plane"][i],
                                        _plane_coords(xyz, i))
            line_feat = grid_sample_1d(params["density_line"][i],
                                       xyz[..., VEC_MODE[i]])
            contrib = torch.sum(plane_feat * line_feat, dim=-1)
            sigma = contrib if sigma is None else sigma + contrib
        return sigma
    # CP: elementwise product of the three line features, summed over rank
    prod = None
    for i in range(3):
        line_feat = grid_sample_1d(params["density_line"][i],
                                   xyz[..., VEC_MODE[i]])
        prod = line_feat if prod is None else prod * line_feat
    return torch.sum(prod, dim=-1)


def compute_appfeature(config: FieldConfig, params,
                       xyz: torch.Tensor) -> torch.Tensor:
    """Appearance feature at normalized coords xyz [..., 3] -> [..., app_dim]
    (reference tensoRF.py:237-256 VM / :361-375 CP)."""
    if config.model_name == "TensorVMSplit":
        feats = []
        for i in range(3):
            plane_feat = grid_sample_2d(params["app_plane"][i],
                                        _plane_coords(xyz, i))
            line_feat = grid_sample_1d(params["app_line"][i],
                                       xyz[..., VEC_MODE[i]])
            feats.append(plane_feat * line_feat)
        feat = torch.cat(feats, dim=-1)
    else:
        feat = None
        for i in range(3):
            line_feat = grid_sample_1d(params["app_line"][i],
                                       xyz[..., VEC_MODE[i]])
            feat = line_feat if feat is None else feat * line_feat
    return linear_apply(params["basis_mat"], feat)
