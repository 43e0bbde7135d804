"""Tensor-factorized radiance fields (TensorVMSplit / TensorCP), inference
(reference models/tensoRF.py:151-443, models/tensorBase.py:262-773).

A frozen ``FieldConfig`` carries the static description (grid, ranks,
AABB, derived step size and sample counts); parameters are a dict of
tensors in the JAX package's layout: planes ``[H, W, R]``, lines
``[L, R]``, Linear weights ``[in, out]``. Axis conventions follow the
reference (tensorBase.py:311-312): ``MAT_MODE = ((0,1),(0,2),(1,2))``,
``VEC_MODE = (2,1,0)`` -- plane ``i`` is indexed by (x=xyz[m0],
y=xyz[m1]) and line ``i`` by xyz[vec].

Features are evaluated densely, by ``compute_features``: where
``use_fused_eval`` says so through ``compute_features_fused``, which runs a
TensorVMSplit field's texel fetches and lerps in one kernel
(``ops/field_features.py``), else through ``compute_densityfeature`` and
``compute_appfeature`` and the grid samplers, whose texel fetches run on
the row-gather kernel (``ops/gather.py``). The footprint packing, the
compaction ladder and the grouped bit-row mask gate of the JAX package work
around the TPU's gather row rate and are not ported; their ``FieldConfig``
fields are kept so that ``config_json`` round-trips.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from iffnerf_tpu_torch.nn import linear_apply
from iffnerf_tpu_torch.ops.field_features import (
    VEC_MODE,
    field_features,
    vm_app_products,
    vm_density,
)
from iffnerf_tpu_torch.ops.grid_sample import grid_sample_1d, grid_sample_3d


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
    # "auto": the fused feature kernel for TensorVMSplit on CUDA tensors,
    # the grid samplers elsewhere; "on"/"off" force either (use_fused_eval)
    fused_eval: str = "auto"
    # TPU evaluation settings of the JAX package, read by nothing here
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


def use_fused_eval(config: FieldConfig, device) -> bool:
    """Whether features at points on ``device`` go through
    ``compute_features_fused`` (the JAX package's ``use_fused_eval``):
    never for TensorCP; for TensorVMSplit "on" always, "off" never, "auto"
    on CUDA."""
    if config.model_name != "TensorVMSplit":
        return False
    if config.fused_eval == "auto":
        return torch.device(device).type == "cuda"
    return config.fused_eval == "on"


def compute_densityfeature(config: FieldConfig, params,
                           xyz: torch.Tensor) -> torch.Tensor:
    """sigma feature at normalized coords xyz [..., 3] -> [...]
    (reference tensoRF.py:216-235 VM / :344-359 CP)."""
    if config.model_name == "TensorVMSplit":
        return vm_density(params, xyz)
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
        feat = vm_app_products(params, xyz)
    else:
        feat = None
        for i in range(3):
            line_feat = grid_sample_1d(params["app_line"][i],
                                       xyz[..., VEC_MODE[i]])
            feat = line_feat if feat is None else feat * line_feat
    return linear_apply(params["basis_mat"], feat)


def compute_features_fused(config: FieldConfig, params, xyz: torch.Tensor,
                           with_app: bool = True):
    """Density and appearance features of a TensorVMSplit field at
    normalized coords xyz [..., 3] in one kernel pass (the JAX package's
    ``compute_features_fused``; ``ops/field_features.py``): (sigma feature
    [...], appearance feature [..., app_dim], or None without
    ``with_app``). The same values as ``compute_densityfeature`` and
    ``compute_appfeature`` up to the order of sigma's sum over ranks."""
    sigma, products = field_features(config, params, xyz, with_app)
    if products is None:
        return sigma, None
    return sigma, linear_apply(params["basis_mat"], products)


def compute_features(config: FieldConfig, params, xyz: torch.Tensor,
                     with_density: bool = True, with_app: bool = True):
    """(sigma feature [...] or None, appearance feature [..., app_dim] or
    None) at normalized coords xyz [..., 3]: from ``compute_features_fused``
    where ``use_fused_eval`` says so, else from ``compute_densityfeature``
    and ``compute_appfeature``."""
    if use_fused_eval(config, xyz.device):
        sigma, app = compute_features_fused(config, params, xyz, with_app)
        return sigma if with_density else None, app
    return (compute_densityfeature(config, params, xyz) if with_density
            else None,
            compute_appfeature(config, params, xyz) if with_app else None)
