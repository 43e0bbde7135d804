"""Shading heads: per-ray colour decoders selected by ``shading_mode``
(reference models/tensorBase.py:38-47,138-259, models/ref.py:48-155).

Every head takes ``(params, pts, viewdirs, features)`` and returns
``(rgb, extra)``; the Ref head also gives ``compute_normals``
(models/ref.py:154-155), the surface normals of the pose pipeline.
``init_shading`` makes a head's parameters from a ``torch.Generator``
(reference models/tensorBase.py:328-352).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from iffnerf_tpu_torch.nn import linear_apply, linear_init, mlp_apply, mlp_init
from iffnerf_tpu_torch.ops.encoding import positional_encoding
from iffnerf_tpu_torch.ops.ide import ide_output_dim, integrated_dir_enc
from iffnerf_tpu_torch.ops.image import linear_to_srgb
from iffnerf_tpu_torch.ops.sh import eval_sh_bases

RGB_PADDING = 0.001  # reference models/ref.py:64


def reflect(viewdirs: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """Mirror viewdirs about normals (reference models/ref_utils.py:6-20)."""
    return (2.0 * torch.sum(normals * viewdirs, dim=-1, keepdim=True)
            * normals - viewdirs)


def init_ref(gen: torch.Generator, in_channels: int, feature_c: int = 128,
             deg_view: int = 4, predicted_normals: bool = True):
    """Ref head parameters (reference models/ref.py:48-101)."""
    params = {
        "diffuse": linear_init(gen, in_channels, 3),
        "tint": linear_init(gen, in_channels, 3),
        "roughness": linear_init(gen, in_channels, 1),
        "bottleneck": linear_init(gen, in_channels, feature_c),
        "specular": linear_init(gen, feature_c + ide_output_dim(deg_view) + 1,
                                3),
    }
    if predicted_normals:
        params["normal"] = linear_init(gen, in_channels, 3)
    return params


def init_mlp_head(gen: torch.Generator, dims):
    """An MLP head: Linear layers of ``dims``, the last bias zero
    (reference models/tensorBase.py:165-259)."""
    return {"mlp": mlp_init(gen, dims, zero_last_bias=True)}


def init_shading(gen: torch.Generator, shading_mode: str, app_dim: int,
                 view_pe: int, pos_pe: int, fea_pe: int, feature_c: int):
    """Parameters of the head ``shading_mode`` (reference
    models/tensorBase.py:328-352)."""
    if shading_mode == "Ref":
        return init_ref(gen, app_dim, feature_c)
    if shading_mode == "MLP_Fea":
        in_c = 2 * view_pe * 3 + 2 * fea_pe * app_dim + 3 + app_dim
        return init_mlp_head(gen, [in_c, feature_c, feature_c, 3])
    if shading_mode == "MLP_PE":
        in_c = (3 + 2 * view_pe * 3) + (3 + 2 * pos_pe * 3) + app_dim
        return init_mlp_head(gen, [in_c, feature_c, feature_c, 3])
    if shading_mode == "MLP":
        in_c = (3 + 2 * view_pe * 3) + app_dim
        return init_mlp_head(gen, [in_c, feature_c, feature_c, 3])
    if shading_mode == "MLP_GARF":
        in_c = 3 + app_dim
        return init_mlp_head(gen, [in_c, in_c, in_c, in_c])
    if shading_mode in ("SH", "RGB"):
        return {}
    raise ValueError(f"Unrecognized shading mode: {shading_mode}")


def ref_normals(params, features: torch.Tensor) -> torch.Tensor:
    """The raw normal-MLP output: -normalize(linear(features))
    (reference ``normal_mlp``, models/ref.py:85-89)."""
    raw = linear_apply(params["normal"], features)
    norm = torch.linalg.norm(raw, dim=-1, keepdim=True)
    return -(raw / torch.clamp_min(norm, 1e-12))


def apply_ref(params, pts, viewdirs, features, normals=None,
              deg_view: int = 4):
    """Ref head forward (reference models/ref.py:103-152)."""
    if normals is None:
        normals = ref_normals(params, features)

    tint = torch.sigmoid(linear_apply(params["tint"], features))
    roughness = F.softplus(linear_apply(params["roughness"], features) - 1.0)
    bottleneck = linear_apply(params["bottleneck"], features)

    refdirs = reflect(-viewdirs, normals)
    dir_enc = integrated_dir_enc(refdirs, roughness, deg_view)

    dotprod = torch.sum(normals * viewdirs, dim=-1, keepdim=True)
    x = torch.cat([bottleneck, dir_enc, dotprod], dim=-1)

    specular = torch.sigmoid(linear_apply(params["specular"], x))
    specular_linear = tint * specular
    diffuse_linear = torch.sigmoid(
        linear_apply(params["diffuse"], features) - math.log(3.0))

    rgb = torch.clamp(linear_to_srgb(specular_linear + diffuse_linear),
                      0.0, 1.0)
    return rgb * (1.0 + 2.0 * RGB_PADDING) - RGB_PADDING, None


def _mlp_rgb(params, indata):
    return torch.sigmoid(mlp_apply(params["mlp"], torch.cat(indata, -1))), None


def apply_mlp_fea(params, pts, viewdirs, features, viewpe: int, feape: int):
    indata = [features, viewdirs]
    if feape > 0:
        indata.append(positional_encoding(features, feape))
    if viewpe > 0:
        indata.append(positional_encoding(viewdirs, viewpe))
    return _mlp_rgb(params, indata)


def apply_mlp_pe(params, pts, viewdirs, features, viewpe: int, pospe: int):
    indata = [features, viewdirs]
    if pospe > 0:
        indata.append(positional_encoding(pts, pospe))
    if viewpe > 0:
        indata.append(positional_encoding(viewdirs, viewpe))
    return _mlp_rgb(params, indata)


def apply_mlp(params, pts, viewdirs, features, viewpe: int):
    indata = [features, viewdirs]
    if viewpe > 0:
        indata.append(positional_encoding(viewdirs, viewpe))
    return _mlp_rgb(params, indata)


def apply_mlp_gaussian(params, pts, viewdirs, features):
    x = torch.cat([features, viewdirs], dim=-1)
    raw = mlp_apply(params["mlp"], x, activation=F.celu)
    return torch.sigmoid(raw[..., :3]), raw[..., 3:]


def apply_sh(params, pts, viewdirs, features):
    """SH shading (reference models/tensorBase.py:38-42)."""
    sh_mult = eval_sh_bases(2, viewdirs)[..., None, :]
    rgb_sh = features.reshape(features.shape[:-1] + (3, sh_mult.shape[-1]))
    return torch.relu(torch.sum(sh_mult * rgb_sh, dim=-1) + 0.5), None


def apply_rgb(params, pts, viewdirs, features):
    return features, None


def apply_shading(params, shading_mode: str, pts, viewdirs, features,
                  view_pe: int = 6, pos_pe: int = 6, fea_pe: int = 6):
    if shading_mode == "Ref":
        return apply_ref(params, pts, viewdirs, features)
    if shading_mode == "MLP_Fea":
        return apply_mlp_fea(params, pts, viewdirs, features, view_pe, fea_pe)
    if shading_mode == "MLP_PE":
        return apply_mlp_pe(params, pts, viewdirs, features, view_pe, pos_pe)
    if shading_mode == "MLP":
        return apply_mlp(params, pts, viewdirs, features, view_pe)
    if shading_mode == "MLP_GARF":
        return apply_mlp_gaussian(params, pts, viewdirs, features)
    if shading_mode == "SH":
        return apply_sh(params, pts, viewdirs, features)
    if shading_mode == "RGB":
        return apply_rgb(params, pts, viewdirs, features)
    raise ValueError(f"Unrecognized shading mode: {shading_mode}")


def compute_normals(params, shading_mode: str, features: torch.Tensor):
    """Surface normals from the Ref head (reference models/ref.py:154-155)."""
    if shading_mode != "Ref":
        raise ValueError(f"normals require the Ref shading head, got "
                         f"{shading_mode}")
    return -ref_normals(params, features)
