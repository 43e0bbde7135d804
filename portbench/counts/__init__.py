"""The benchmark's own operation and byte counts, and the peaks they are
held to.

Counts are of the model's math at the cell's shapes, never of the route
the program takes: a change that drops redundant work leaves them as they
are. Least times count each input read once and each output written once
(a table read once whole, a gradient table written once whole).

Peaks: NVIDIA's H100 SXM data sheet, dense (HBM3 3.35 TB/s, TF32 495
TFLOP/s). A float32-accurate product counts at the rate of three TF32
products (495 / 3 TFLOP/s), the rate of the port's float32 tensor-core
kernels, so that no float32 route can read above its peak; every float32
operation is held to that rate.
"""

from __future__ import annotations

import math

PEAK_F32 = 495e12 / 3
PEAK_BYTES = 3.35e12


def least_s(flops: float, bytes_: float, peak: float = PEAK_F32) -> float:
    """The least seconds the card could take: the larger of the operations
    at ``peak`` and the bytes at HBM3's rate."""
    return max(flops / peak, bytes_ / PEAK_BYTES)


# --------------------------------------------------------------------------
# the pose head
# --------------------------------------------------------------------------


def vit_forward_flops(vit: dict) -> float:
    """DINOv2 ViT forward at ``img_size``: patch embedding, and per block
    qkv, the two attention products, the output projection and the MLP."""
    d, p = vit["dim"], vit["patch_size"]
    n_patch = (vit["img_size"] // p) ** 2
    n = 1 + n_patch
    h = d * vit["mlp_ratio"]
    block = 2 * n * (d * 3 * d + d * d + 2 * d * h) + 2 * 2 * n * n * d
    return 2 * n_patch * p * p * 3 * d + vit["depth"] * block


def pe_channels(pose: dict) -> int:
    return 2 + 4 * pose["pe_freqs"]


def query_flops(pose: dict) -> float:
    d = pose["vit"]["dim"]
    n_patch = (pose["vit"]["img_size"] // pose["vit"]["patch_size"]) ** 2
    return 2 * n_patch * (d + pe_channels(pose)) * d


def logit_flops(pose: dict, rays: int) -> float:
    d = pose["vit"]["dim"]
    n_patch = (pose["vit"]["img_size"] // pose["vit"]["patch_size"]) ** 2
    return 2 * n_patch * rays * d


def pose_frame_flops(pose: dict, rays: int) -> float:
    """A frame's model math against a bank: ViT forward, q, logits."""
    return vit_forward_flops(pose["vit"]) + query_flops(pose) \
        + logit_flops(pose, rays)


def k1_least_s(pose: dict, rays: int, elem_bytes: int = 4,
               peak: float = PEAK_F32) -> float:
    """K1's least time a frame: the logits' products at ``peak``, or the
    bank [R, D] read once."""
    d = pose["vit"]["dim"]
    return least_s(logit_flops(pose, rays), rays * d * elem_bytes, peak)


def ray_in_dim(pose: dict) -> int:
    return sum(3 + 6 * pose[k] for k in ("ray_pos_pe", "ray_view_pe",
                                        "ray_rgb_pe"))


def ray_mlp_macs(pose: dict) -> int:
    """Multiply-adds a ray of the ray MLP: in -> fc -> fc, [fc + in] -> fc
    -> D."""
    i, fc, d = ray_in_dim(pose), pose["ray_feature_c"], pose["vit"]["dim"]
    return i * fc + fc * fc + (fc + i) * fc + fc * d


def id_step_flops(pose: dict, rays: int, images: int) -> float:
    """An ID-module step's model math: the ray MLP and the k projection
    forward and backward once, and each image's ViT, q and logits forward
    and backward (a backward twice its forward)."""
    d = pose["vit"]["dim"]
    once = 3 * 2 * rays * (ray_mlp_macs(pose) + d * d)
    per_image = 3 * (vit_forward_flops(pose["vit"]) + query_flops(pose)
                     + logit_flops(pose, rays))
    return once + images * per_image


# --------------------------------------------------------------------------
# the field
# --------------------------------------------------------------------------


MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)


def n_samples(field: dict, cap: int = 10 ** 6) -> int:
    """Samples a ray at the field's grid (TensoRF ``cal_n_samples``)."""
    norm = math.sqrt(sum(g * g for g in field["grid_size"]))
    return min(cap, int(norm / field["step_ratio"]))


def is_cp(field: dict) -> bool:
    return field["model_name"] == "TensorCP"


def app_ranks(field: dict) -> int:
    return field["app_n_comp"][0] if is_cp(field) else sum(field["app_n_comp"])


def table_elems(field: dict) -> int:
    """Elements of the factor grids."""
    g = field["grid_size"]
    if is_cp(field):
        return sum(g[VEC_MODE[i]] * (field["density_n_comp"][0]
                                     + field["app_n_comp"][0])
                   for i in range(3))
    total = 0
    for i, (m0, m1) in enumerate(MAT_MODE):
        r = field["density_n_comp"][i] + field["app_n_comp"][i]
        total += (g[m0] * g[m1] + g[VEC_MODE[i]]) * r
    return total


def sample_flops(field: dict) -> float:
    """A sample's forward math: each rank's interpolation (bilinear 7,
    linear 3), its product and the density's sum, and ``basis_mat``."""
    if is_cp(field):
        interp = 3 * (field["density_n_comp"][0] + field["app_n_comp"][0]) * 3
        prods = 2 * (field["density_n_comp"][0] + field["app_n_comp"][0])
        dens_sum = field["density_n_comp"][0]
    else:
        ranks = [field["density_n_comp"][i] + field["app_n_comp"][i]
                 for i in range(3)]
        interp = sum(r * (7 + 3) for r in ranks)
        prods = sum(ranks)
        dens_sum = sum(field["density_n_comp"])
    return interp + prods + dens_sum + 2 * app_ranks(field) * field["app_dim"]


def shading_flops(field: dict) -> float:
    """A ray's Ref head: the normal, tint, roughness, diffuse and bottleneck
    layers and the specular layer on [bottleneck, IDE, n . v]."""
    a, fc = field["app_dim"], field["feature_c"]
    ide = sum(2 ** i + 1 for i in range(4)) * 2
    return 2 * (a * (3 + 3 + 1 + 3 + fc) + (fc + ide + 1) * 3)


def train_step_flops(field: dict, rays: int, samples: int) -> float:
    """A training step's model math, forward and backward (twice the
    forward)."""
    return 3 * (rays * samples * sample_flops(field)
                + rays * shading_flops(field))


def field_least_s(field: dict, samples: int, mask_cells: int) -> float:
    """The field kernels' least time a step: the features forward
    (coordinates read, sigma and the appearance products written, the
    tables read), their backward (coordinates and both upstreams read, the
    tables read and their gradients written) and the alpha-mask gather
    (8 corner indices read and 8 values written a sample, the mask read)."""
    n, r = samples, app_ranks(field)
    tables = 4 * table_elems(field)
    fwd = n * 12 + n * 4 + n * r * 4 + tables
    bwd = n * 12 + n * 4 + n * r * 4 + 2 * tables
    gather = n * 8 * 4 * 2 + mask_cells * 4
    return sum(b / PEAK_BYTES for b in (fwd, bwd, gather))
