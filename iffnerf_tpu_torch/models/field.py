"""Tensor-factorized radiance fields (TensorVMSplit / TensorCP): inference
and the training math (reference models/tensoRF.py:151-443,
models/tensorBase.py:262-773).

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
(``ops/field_features.py``); where ``use_cp_kernel`` says so, a TensorCP
field's in the CP kernel (``ops/cp_features.py``); else through
``compute_densityfeature`` and ``compute_appfeature`` and the grid
samplers, whose texel fetches run on the row-gather kernel
(``ops/gather.py``). The footprint packing, the
compaction ladder and the grouped bit-row mask gate of the JAX package work
around the TPU's gather row rate and are not ported; their ``FieldConfig``
fields are kept so that ``config_json`` round-trips.

Training adds ``init_field`` (from a ``torch.Generator``), the
regularisers, and the phase events of the JAX package's trainer:
``upsample_volume_grid``, ``shrink`` and ``update_alpha_mask``. Each
event returns new tensors and a new config; nothing is changed in place.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from iffnerf_tpu_torch.models.shading import init_shading
from iffnerf_tpu_torch.nn import linear_apply, linear_init
from iffnerf_tpu_torch.ops.cp_features import (
    cp_app_products,
    cp_density,
    cp_features,
)
from iffnerf_tpu_torch.ops.field_features import (
    MAT_MODE,
    VEC_MODE,
    field_features,
    vm_app_products,
    vm_density,
)
from iffnerf_tpu_torch.ops.grid_sample import grid_sample_3d
from iffnerf_tpu_torch.ops.interpolate import resize_bilinear_ac, resize_linear_ac

# lattice points a chunk of get_dense_alpha (bounds its device temporaries)
DENSE_ALPHA_CHUNK = 1 << 22


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
    # the grid samplers elsewhere; "on"/"off" force either (use_fused_eval).
    # TensorCP takes its own kernel on CUDA unless "off" (use_cp_kernel)
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

    def replace(self, **kw) -> "FieldConfig":
        return dataclasses.replace(self, **kw)


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


def power_transformation_inv(center_metric: torch.Tensor,
                             alpha: float = -1.5) -> torch.Tensor:
    """Inverse of the Zip-NeRF power contraction
    (reference utils.py:150-163)."""
    negate_alpha = math.fabs(alpha - 1)
    return (torch.sign(center_metric)
            * (torch.pow((alpha * torch.abs(center_metric) + negate_alpha)
                         / negate_alpha, 1.0 / alpha) - 1.0)
            * negate_alpha)


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


def use_cp_kernel(config: FieldConfig, device) -> bool:
    """Whether a TensorCP field's features at points on ``device`` go
    through the CP kernel (``ops/cp_features.py``): on CUDA, unless
    ``fused_eval`` is "off" (then the grid samplers on the row gather, as
    the JAX package computes them); never for TensorVMSplit, whose kernel
    ``use_fused_eval`` decides."""
    return (config.model_name == "TensorCP" and config.fused_eval != "off"
            and torch.device(device).type == "cuda")


def compute_densityfeature(config: FieldConfig, params,
                           xyz: torch.Tensor) -> torch.Tensor:
    """sigma feature at normalized coords xyz [..., 3] -> [...]
    (reference tensoRF.py:216-235 VM / :344-359 CP)."""
    if config.model_name == "TensorVMSplit":
        return vm_density(params, xyz)
    # CP: elementwise product of the three line features, summed over rank
    if use_cp_kernel(config, xyz.device):
        return cp_features(config, params, xyz, with_app=False)[0]
    return cp_density(params, xyz)


def compute_appfeature(config: FieldConfig, params,
                       xyz: torch.Tensor) -> torch.Tensor:
    """Appearance feature at normalized coords xyz [..., 3] -> [..., app_dim]
    (reference tensoRF.py:237-256 VM / :361-375 CP)."""
    if config.model_name == "TensorVMSplit":
        feat = vm_app_products(params, xyz)
    elif use_cp_kernel(config, xyz.device):
        feat = cp_features(config, params, xyz)[1]
    else:
        feat = cp_app_products(params, xyz)
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
    where ``use_fused_eval`` says so, from one CP kernel pass where
    ``use_cp_kernel`` does, else from ``compute_densityfeature`` and
    ``compute_appfeature``."""
    if use_fused_eval(config, xyz.device):
        sigma, app = compute_features_fused(config, params, xyz, with_app)
        return sigma if with_density else None, app
    if use_cp_kernel(config, xyz.device):
        sigma, products = cp_features(config, params, xyz, with_app)
        return (sigma if with_density else None,
                None if products is None
                else linear_apply(params["basis_mat"], products))
    return (compute_densityfeature(config, params, xyz) if with_density
            else None,
            compute_appfeature(config, params, xyz) if with_app else None)


# ---------------------------------------------------------------------------
# Initialisation (reference tensoRF.py:155-170, :323-326)
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return scale * torch.randn(shape, generator=gen, device=gen.device)


def _init_vm(gen: torch.Generator, n_comp, grid_size, scale: float):
    """Per-axis plane [g[m1], g[m0], R] and line [g[vec], R] gaussians
    (reference init_one_svd, tensoRF.py:160-170)."""
    planes, lines = [], []
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        planes.append(_normal(gen, (grid_size[m1], grid_size[m0], n_comp[i]),
                              scale))
        lines.append(_normal(gen, (grid_size[VEC_MODE[i]], n_comp[i]), scale))
    return tuple(planes), tuple(lines)


def _init_cp(gen: torch.Generator, n_comp: int, grid_size, scale: float):
    return tuple(_normal(gen, (grid_size[VEC_MODE[i]], n_comp), scale)
                 for i in range(3))


def init_field(gen: torch.Generator, config: FieldConfig):
    """All field parameters, drawn from ``gen`` on its device (reference
    init_svd_volume, tensoRF.py:155-158 / :323-326, and the shading head)."""
    params = {}
    if config.model_name == "TensorVMSplit":
        params["density_plane"], params["density_line"] = _init_vm(
            gen, config.density_n_comp, config.grid_size, 0.1)
        params["app_plane"], params["app_line"] = _init_vm(
            gen, config.app_n_comp, config.grid_size, 0.1)
        in_dim = sum(config.app_n_comp)
    elif config.model_name == "TensorCP":
        params["density_line"] = _init_cp(gen, config.density_n_comp[0],
                                          config.grid_size, 0.2)
        params["app_line"] = _init_cp(gen, config.app_n_comp[0],
                                      config.grid_size, 0.2)
        in_dim = config.app_n_comp[0]
    else:
        raise ValueError(f"unknown model_name {config.model_name}")
    params["basis_mat"] = linear_init(gen, in_dim, config.app_dim, bias=False)
    params["shading"] = init_shading(
        gen, config.shading_mode, config.app_dim, config.view_pe,
        config.pos_pe, config.fea_pe, config.feature_c)
    return params


# ---------------------------------------------------------------------------
# Regularisers (reference tensoRF.py:182-214, :427-443; utils.py:120-137)
# ---------------------------------------------------------------------------


def _tv_plane(plane: torch.Tensor) -> torch.Tensor:
    """TVLoss on one [H, W, R] plane: reference TVLoss(weight=1) on the
    [1, R, H, W] tensor (utils.py:120-136)."""
    h, w, r = plane.shape
    h_tv = torch.sum(torch.square(plane[1:] - plane[:-1]))
    w_tv = torch.sum(torch.square(plane[:, 1:] - plane[:, :-1]))
    return 2.0 * (h_tv / (r * (h - 1) * w) + w_tv / (r * h * (w - 1)))


def _tv_lines(lines) -> torch.Tensor:
    """CP's TV: only the length term of the reference's TVLoss on a
    [1, R, L, 1] tensor (tensoRF.py:433-437)."""
    total = 0.0
    for line in lines:
        length, r = line.shape
        total = total + 2.0 * torch.sum(
            torch.square(line[1:] - line[:-1])) / (r * (length - 1))
    return total


def tv_loss_density(config: FieldConfig, params) -> torch.Tensor:
    if config.model_name == "TensorVMSplit":
        return sum(_tv_plane(p) for p in params["density_plane"]) * 1e-2
    return _tv_lines(params["density_line"]) * 1e-3


def tv_loss_app(config: FieldConfig, params) -> torch.Tensor:
    if config.model_name == "TensorVMSplit":
        return sum(_tv_plane(p) for p in params["app_plane"]) * 1e-2
    return _tv_lines(params["app_line"]) * 1e-3


def density_l1(config: FieldConfig, params) -> torch.Tensor:
    """L1 sparsity of the density factors (tensoRF.py:197-202, :427-431)."""
    total = 0.0
    for i in range(3):
        if config.model_name == "TensorVMSplit":
            total = total + torch.mean(torch.abs(params["density_plane"][i]))
        total = total + torch.mean(torch.abs(params["density_line"][i]))
    return total


def _vector_diffs(lines) -> torch.Tensor:
    """Mean |off-diagonal| of the line components' Gram matrices
    (reference vectorDiffs, tensoRF.py:182-192)."""
    total = 0.0
    for line in lines:
        r = line.shape[1]
        gram = line.T @ line
        off = gram.reshape(-1)[1:].reshape(r - 1, r + 1)[:, :-1]
        total = total + torch.mean(torch.abs(off))
    return total


def vector_comp_diffs(config: FieldConfig, params) -> torch.Tensor:
    return (_vector_diffs(params["density_line"])
            + _vector_diffs(params["app_line"]))


# ---------------------------------------------------------------------------
# Phase events: upsample, shrink, alpha-mask update
# ---------------------------------------------------------------------------


def upsample_volume_grid(config: FieldConfig, params, res_target):
    """Bilinear grid upsample (reference tensoRF.py:258-278, :377-395)
    -> (new config, new params), new tensors for every factor."""
    res_target = tuple(int(r) for r in res_target)
    new_params = dict(params)

    def lines_up(lines):
        return tuple(resize_linear_ac(lines[i], res_target[VEC_MODE[i]], 0)
                     for i in range(3))

    for kind in ("density", "app"):
        if config.model_name == "TensorVMSplit":
            new_params[f"{kind}_plane"] = tuple(
                resize_bilinear_ac(params[f"{kind}_plane"][i], res_target[m1],
                                   res_target[m0])
                for i, (m0, m1) in enumerate(MAT_MODE))
        new_params[f"{kind}_line"] = lines_up(params[f"{kind}_line"])
    return config.replace(grid_size=res_target), new_params


def shrink(config: FieldConfig, params, new_aabb, mask_grid_size):
    """Crop the factor grids to a tightened AABB (reference
    tensoRF.py:280-316); the index arithmetic on the host in numpy, as the
    JAX package does. ``new_aabb`` [2, 3]; ``mask_grid_size`` the alpha
    mask's (x, y, z) size, which decides whether the AABB is snapped to the
    grid. -> (new config, new params), the factors as contiguous copies."""
    new_aabb = np.asarray(new_aabb, dtype=np.float32)
    units = config.units
    aabb = config.aabb_np
    grid_size = np.asarray(config.grid_size, dtype=np.int64)

    t_l = np.round(np.round((new_aabb[0] - aabb[0]) / units)).astype(np.int64)
    b_r = np.round((new_aabb[1] - aabb[0]) / units).astype(np.int64) + 1
    b_r = np.minimum(b_r, grid_size)

    new_params = dict(params)
    for kind in ("density", "app"):
        new_params[f"{kind}_line"] = tuple(
            params[f"{kind}_line"][i][t_l[VEC_MODE[i]]:b_r[VEC_MODE[i]]]
            .contiguous() for i in range(3))
        if config.model_name == "TensorVMSplit":
            new_params[f"{kind}_plane"] = tuple(
                params[f"{kind}_plane"][i][t_l[m1]:b_r[m1], t_l[m0]:b_r[m0]]
                .contiguous() for i, (m0, m1) in enumerate(MAT_MODE))

    if not np.array_equal(np.asarray(mask_grid_size), grid_size):
        t_l_r = t_l / (grid_size - 1)
        b_r_r = (b_r - 1) / (grid_size - 1)
        new_aabb = np.stack([(1 - t_l_r) * aabb[0] + t_l_r * aabb[1],
                             (1 - b_r_r) * aabb[0] + b_r_r * aabb[1]]
                            ).astype(np.float32)
    new_size = tuple(int(x) for x in (b_r - t_l))
    return config.replace(aabb=tuple(map(tuple, new_aabb.tolist())),
                          grid_size=new_size), new_params


def _lattice_axis(g: int) -> np.ndarray:
    """``jnp.linspace(0, 1, g)`` as the JAX package's CPU backend rounds it:
    i * (1 / (g - 1)) in float32, the last point 1."""
    if g == 1:
        return np.zeros(1, np.float32)
    axis = np.arange(g, dtype=np.float32) * (np.float32(1) / np.float32(g - 1))
    axis[-1] = 1.0
    return axis


def get_dense_alpha(config: FieldConfig, params, mask: AlphaMask | None,
                    grid_size=None):
    """Alpha on a dense lattice over the AABB (reference
    tensorBase.py:643-665), evaluated in chunks of DENSE_ALPHA_CHUNK points
    through the density-only features -> (alpha [gx, gy, gz], dense_xyz
    [gx, gy, gz, 3]) on the parameters' device."""
    from iffnerf_tpu_torch.models.render import compute_alpha  # cycle

    grid_size = tuple(int(g) for g in (grid_size or config.grid_size))
    dev = params["density_line"][0].device
    aabb = torch.as_tensor(config.aabb_np, device=dev)
    axes = [torch.as_tensor(_lattice_axis(g), device=dev) for g in grid_size]
    samples = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    dense_xyz = aabb[0] * (1 - samples) + aabb[1] * samples
    flat = dense_xyz.reshape(-1, 3)
    alpha = torch.cat([
        compute_alpha(config, params, mask, flat[i:i + DENSE_ALPHA_CHUNK],
                      config.step_size)
        for i in range(0, flat.shape[0], DENSE_ALPHA_CHUNK)])
    return alpha.reshape(grid_size), dense_xyz


@torch.no_grad()
def update_alpha_mask(config: FieldConfig, params, mask: AlphaMask | None,
                      grid_size=(200, 200, 200)):
    """Rebuild the occupancy mask and tighten the AABB (reference
    updateAlphaMask, tensorBase.py:667-696) -> (new mask, new aabb [2, 3]
    numpy, occupied fraction)."""
    grid_size = tuple(int(g) for g in grid_size)
    alpha, dense_xyz = get_dense_alpha(config, params, mask, grid_size)
    # x-major -> z-major volume, 3^3 max-pool with -inf padding, threshold
    vol = torch.clamp(alpha, 0.0, 1.0).permute(2, 1, 0).contiguous()
    vol = F.max_pool3d(vol[None, None], kernel_size=3, stride=1,
                       padding=1)[0, 0]
    vol = (vol >= config.alpha_mask_thres).float()
    new_mask = make_alpha_mask(vol, config.aabb_np, config.contraction_type)
    occupied = vol > 0.5
    valid = dense_xyz.permute(2, 1, 0, 3)[occupied]
    if valid.shape[0] == 0:
        new_aabb = config.aabb_np
    else:
        new_aabb = torch.stack([valid.amin(0), valid.amax(0)]).cpu().numpy()
    occupancy = float(vol.sum() / vol.numel())  # float32, as JAX's
    return new_mask, new_aabb, occupancy
