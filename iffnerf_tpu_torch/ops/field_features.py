"""The TensorVMSplit field's features in one pass: ``field_features``.

For each sample and each of the 3 axis pairs it bilerps plane i's 4 corner
rows, lerps line i's 2 corner rows, multiplies the two, sums the density
ranks into the sigma feature and emits the appearance products (before
``basis_mat``, which stays a ``torch.matmul`` in ``models/field.py``). This
is ``compute_features_fused`` of the JAX package
(``iffnerf_tpu/models/field.py:394``), whose TPU design packs each plane's
4-texel footprint into one gathered row (the work of the Pallas kernel
``pallas_gather``, ``extra/pallas_gather_bench.py:46``). On Hopper the
kernel ``csrc/field_features.cu`` gathers the corner texels into registers
and lerps them there: no corner row reaches device memory, and one launch
replaces the 18 (density) or 36 (both) texel fetches and their lerps.

``field_features`` launches the kernel for CUDA tensors and takes
``field_features_plain`` (the dense route of ``ops/grid_sample.py``) for
CPU tensors. The semantics are the grid samplers': ``align_corners=True``,
zeros padding, int32 corners clamped with validity flags. Plane i is
``[H, W, R]``, indexed by (xyz[m0] -> W, xyz[m1] -> H) with
``(m0, m1) = MAT_MODE[i]``; line i is ``[L, R]``, indexed by
xyz[VEC_MODE[i]] (reference tensorBase.py:311-312).
"""

from __future__ import annotations

import ctypes

import torch

from iffnerf_tpu_torch.ops import _build
from iffnerf_tpu_torch.ops.grid_sample import grid_sample_1d, grid_sample_2d

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)

_SIGNATURES = {
    "iff_field_features": [ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.POINTER(ctypes.c_longlong),
                           ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p],
}
BLOCKS_PER_SM = 8  # grid cap of the grid-stride loop


def plane_coords(xyz: torch.Tensor, i: int) -> torch.Tensor:
    """(x, y) coords of plane ``i`` at xyz [..., 3] -> [..., 2]."""
    m0, m1 = MAT_MODE[i]
    return torch.stack([xyz[..., m0], xyz[..., m1]], dim=-1)


def vm_products(planes, lines, xyz: torch.Tensor):
    """Plane-times-line features of each axis pair at xyz [..., 3] through
    the grid samplers -> three [..., R_i] tensors."""
    return [grid_sample_2d(planes[i], plane_coords(xyz, i))
            * grid_sample_1d(lines[i], xyz[..., VEC_MODE[i]])
            for i in range(3)]


def vm_density(params, xyz: torch.Tensor) -> torch.Tensor:
    """sigma feature [...] of a TensorVMSplit field at xyz [..., 3]."""
    sigma = None
    for prod in vm_products(params["density_plane"], params["density_line"],
                            xyz):
        contrib = torch.sum(prod, dim=-1)
        sigma = contrib if sigma is None else sigma + contrib
    return sigma


def vm_app_products(params, xyz: torch.Tensor) -> torch.Tensor:
    """Appearance products [..., sum(R_app)] of a TensorVMSplit field at
    xyz [..., 3], plane 0's ranks first (the input of ``basis_mat``)."""
    return torch.cat(vm_products(params["app_plane"], params["app_line"], xyz),
                     dim=-1)


def field_features_plain(params, xyz: torch.Tensor, with_app: bool = True):
    """The kernel's function through the grid samplers: (sigma feature
    [...], appearance products [..., sum(R_app)] or None)."""
    sigma = vm_density(params, xyz)
    return sigma, vm_app_products(params, xyz) if with_app else None


def kernel_layout(params, with_app: bool):
    """The kernel's per-plane arguments from the parameters' shapes ->
    (tables, dims). ``tables`` is the 12 tensors (density planes, density
    lines, app planes, app lines; the app ones None without ``with_app``);
    ``dims`` is 19 ints: (H, W, L, R_density, R_app) for each axis pair,
    then the first output column of each pair's app products and their
    total width (R_app and the columns 0 without ``with_app``)."""
    kinds = ("density", "app") if with_app else ("density",)
    tables = []
    for kind in ("density", "app"):
        for part in ("plane", "line"):
            tables += (list(params[f"{kind}_{part}"]) if kind in kinds
                       else [None] * 3)
    dims, offsets, col = [], [], 0
    for i in range(3):
        h, w, rd = tables[i].shape
        length = tables[3 + i].shape[0]
        if tables[3 + i].shape[1] != rd:
            raise ValueError(f"density plane {i} and line {i} ranks differ")
        ra = 0
        if with_app:
            ah, aw, ra = tables[6 + i].shape
            if (ah, aw) != (h, w) or tuple(tables[9 + i].shape) != (length, ra):
                raise ValueError(f"app plane {i} or line {i} does not match "
                                 f"the density grid ({h}, {w}, {length})")
        dims += [h, w, length, rd, ra]
        offsets.append(col)
        col += ra
    return tables, dims + offsets + [col]


def _check(config, params, xyz):
    if config.model_name != "TensorVMSplit":
        raise ValueError(f"field_features takes a TensorVMSplit field, not "
                         f"{config.model_name}")
    if xyz.dtype != torch.float32 or xyz.shape[-1:] != (3,):
        raise ValueError(f"xyz must be [..., 3] float32, got {xyz.dtype} "
                         f"{tuple(xyz.shape)}")
    for kind in ("density", "app"):
        for part in ("plane", "line"):
            for i, a in enumerate(params[f"{kind}_{part}"]):
                what = f"{kind}_{part}[{i}]"
                if a.dtype != torch.float32:
                    raise ValueError(f"{what} must be float32, got {a.dtype}")
                if not a.is_contiguous():
                    raise ValueError(f"{what} must be contiguous")
                if a.device != xyz.device:
                    raise ValueError(f"{what} is on {a.device}, xyz on "
                                     f"{xyz.device}")


def field_features(config, params, xyz: torch.Tensor, with_app: bool = True):
    """(sigma feature [...], appearance products [..., sum(R_app)] or None
    without ``with_app``) of a TensorVMSplit field at normalized coords xyz
    [..., 3]. CPU tensors take the plain version; CUDA tensors launch the
    kernel (none for no samples) or raise."""
    _check(config, params, xyz)
    if xyz.device.type == "cpu":
        return field_features_plain(params, xyz, with_app)
    if xyz.device.type != "cuda":
        raise ValueError(f"no field-feature kernel for {xyz.device}")
    _build.refuse_grad("field_features", [xyz] + [
        a for kind in ("density", "app") for part in ("plane", "line")
        for a in params[f"{kind}_{part}"]])
    tables, dims = kernel_layout(params, with_app)
    shape = xyz.shape[:-1]
    flat = xyz.reshape(-1, 3).contiguous()
    n = flat.shape[0]
    sigma = torch.empty(n, dtype=torch.float32, device=xyz.device)
    app = (torch.empty((n, dims[-1]), dtype=torch.float32, device=xyz.device)
           if with_app else None)
    if n > 0:
        lib = _build.load("field_features", _SIGNATURES)
        ptrs = [0 if a is None else a.data_ptr() for a in tables]
        vec = (all(r % 4 == 0 for r in dims[3:15:5] + dims[4:15:5])
               and all(p % 16 == 0 for p in ptrs)
               and (app is None or app.data_ptr() % 16 == 0))
        stream = torch.cuda.current_stream(xyz.device).cuda_stream
        rc = lib.iff_field_features(
            flat.data_ptr(), n, (ctypes.c_longlong * 12)(*ptrs),
            (ctypes.c_int * len(dims))(*dims), sigma.data_ptr(),
            0 if app is None else app.data_ptr(), int(vec),
            BLOCKS_PER_SM * _build.sm_count(xyz.device), stream)
        _build.check(rc, "field_features kernel launch")
        field_features.launches += 1
    sigma = sigma.reshape(shape)
    return sigma, None if app is None else app.reshape(shape + (dims[-1],))


field_features.launches = 0
