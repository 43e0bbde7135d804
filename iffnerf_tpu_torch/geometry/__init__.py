"""Geometry / ray utilities (reference: ray_utils.py, dataLoader/ray_utils.py)."""

from iffnerf_tpu_torch.geometry.rays import (
    cast_rays,
    get_ray_directions,
    get_ray_directions_blender,
    get_ray_directions_Ks,
    get_rays,
    get_rays_lie,
    get_rays_simple,
    get_rays_from_parameters,
    ndc_rays_blender,
    sample_pdf,
)
