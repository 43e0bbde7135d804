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

On CUDA the function is differentiable in the tables and in the
coordinates: an ``autograd.Function`` saves the coordinates and the
tables it was given (nothing it computed). For the tables its backward
launches the hand-written kernel ``iff_field_features_bwd`` (the wrapper
``field_features_backward``), which scatter-adds each corner's weight
times the other factor times the upstream gradient into zeroed gradient
tables with atomics; for the coordinates (iNeRF's pose gradient reaches
the sample points) the kernel ``iff_field_features_coords_grad`` (the
wrapper ``field_features_coords_grad``), which sums each sample's
derivatives in its interpolation weights times the upstream gradient.
Each launches only when its inputs require grad. The JAX package
differentiates the same work in XLA
(``iffnerf_tpu/ops/packed_sample.py:234-305``). The plain versions,
``field_features_backward_plain`` and ``field_features_coords_grad_plain``,
are torch's autograd through the grid samplers on ``gather_rows_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from iffnerf_tpu_torch.ops import _build
from iffnerf_tpu_torch.ops.gather import gather_rows_plain
from iffnerf_tpu_torch.ops.grid_sample import grid_sample_1d, grid_sample_2d

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)

_SIGNATURES = {
    "iff_field_features": [ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.POINTER(ctypes.c_longlong),
                           ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p],
    "iff_field_features_bwd": [ctypes.c_void_p, ctypes.c_longlong,
                               ctypes.POINTER(ctypes.c_longlong),
                               ctypes.POINTER(ctypes.c_longlong),
                               ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p],
    "iff_field_features_coords_grad": [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}
TABLES = tuple(f"{kind}_{part}" for kind in ("density", "app")
               for part in ("plane", "line"))
BLOCKS_PER_SM = 8  # grid cap of the grid-stride loop


def plane_coords(xyz: torch.Tensor, i: int) -> torch.Tensor:
    """(x, y) coords of plane ``i`` at xyz [..., 3] -> [..., 2]."""
    m0, m1 = MAT_MODE[i]
    return torch.stack([xyz[..., m0], xyz[..., m1]], dim=-1)


def vm_products(planes, lines, xyz: torch.Tensor, gather=None):
    """Plane-times-line features of each axis pair at xyz [..., 3] through
    the grid samplers, their texels fetched by ``gather`` (None: the
    samplers' own, ``gather_rows``) -> three [..., R_i] tensors."""
    return [grid_sample_2d(planes[i], plane_coords(xyz, i), gather)
            * grid_sample_1d(lines[i], xyz[..., VEC_MODE[i]], gather)
            for i in range(3)]


def vm_density(params, xyz: torch.Tensor, gather=None) -> torch.Tensor:
    """sigma feature [...] of a TensorVMSplit field at xyz [..., 3]."""
    sigma = None
    for prod in vm_products(params["density_plane"], params["density_line"],
                            xyz, gather):
        contrib = torch.sum(prod, dim=-1)
        sigma = contrib if sigma is None else sigma + contrib
    return sigma


def vm_app_products(params, xyz: torch.Tensor,
                    gather=None) -> torch.Tensor:
    """Appearance products [..., sum(R_app)] of a TensorVMSplit field at
    xyz [..., 3], plane 0's ranks first (the input of ``basis_mat``)."""
    return torch.cat(vm_products(params["app_plane"], params["app_line"], xyz,
                                 gather), dim=-1)


def field_features_plain(params, xyz: torch.Tensor, with_app: bool = True,
                         gather=None):
    """The kernel's function through the grid samplers, their texels
    fetched by ``gather``: (sigma feature [...], appearance products
    [..., sum(R_app)] or None)."""
    sigma = vm_density(params, xyz, gather)
    return sigma, vm_app_products(params, xyz, gather) if with_app else None


def field_features_backward_plain(params, xyz: torch.Tensor, dsigma,
                                  dapp=None):
    """The backward's function in plain torch: autograd through the grid
    samplers on ``gather_rows_plain`` (torch indexing, so that it runs on
    the card too) -> {table name: (3 gradients)} for the density tables,
    and the appearance tables when ``dapp`` is given."""
    names = TABLES if dapp is not None else TABLES[:2]
    with torch.enable_grad():
        leaves = {k: tuple(a.detach().requires_grad_() for a in params[k])
                  for k in names}
        sigma, app = field_features_plain(leaves, xyz.detach(),
                                          dapp is not None, gather_rows_plain)
        outs, ups = [sigma], [dsigma]
        if dapp is not None:
            outs.append(app)
            ups.append(dapp)
        flat = [a for k in names for a in leaves[k]]
        grads = torch.autograd.grad(outs, flat, ups, allow_unused=True)
    grads = [torch.zeros_like(a) if g is None else g
             for a, g in zip(flat, grads)]
    return {k: tuple(grads[3 * j:3 * j + 3]) for j, k in enumerate(names)}


def field_features_coords_grad_plain(params, xyz: torch.Tensor, dsigma,
                                     dapp=None) -> torch.Tensor:
    """The coordinate backward's function in plain torch: the gradient of
    sum(sigma * dsigma) (+ sum(app * dapp) when ``dapp`` is given) with
    respect to xyz [..., 3], the tables frozen, by autograd through the
    grid samplers on ``gather_rows_plain`` -> [..., 3]."""
    names = TABLES if dapp is not None else TABLES[:2]
    frozen = {k: tuple(a.detach() for a in params[k]) for k in names}
    with torch.enable_grad():
        leaf = xyz.detach().requires_grad_()
        sigma, app = field_features_plain(frozen, leaf, dapp is not None,
                                          gather_rows_plain)
        outs, ups = [sigma], [dsigma]
        if dapp is not None:
            outs.append(app)
            ups.append(dapp)
        (grad,) = torch.autograd.grad(outs, [leaf], ups)
    return grad


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
    for name in TABLES:
        for i, a in enumerate(params[name]):
            what = f"{name}[{i}]"
            if a.dtype != torch.float32:
                raise ValueError(f"{what} must be float32, got {a.dtype}")
            if not a.is_contiguous():
                raise ValueError(f"{what} must be contiguous")
            if a.device != xyz.device:
                raise ValueError(f"{what} is on {a.device}, xyz on "
                                 f"{xyz.device}")


def _vec(dims, ptrs) -> bool:
    """Whether the kernels take float4 words: every rank a multiple of 4,
    every pointer 16-byte aligned."""
    return (all(r % 4 == 0 for r in dims[3:15:5] + dims[4:15:5])
            and all(p % 16 == 0 for p in ptrs))


def _launch_forward(tables, dims, flat, with_app):
    n = flat.shape[0]
    sigma = torch.empty(n, dtype=torch.float32, device=flat.device)
    app = (torch.empty((n, dims[-1]), dtype=torch.float32, device=flat.device)
           if with_app else None)
    if n > 0:
        lib = _build.load("field_features", _SIGNATURES)
        ptrs = [0 if a is None else a.data_ptr() for a in tables]
        vec = _vec(dims, ptrs + ([] if app is None else [app.data_ptr()]))
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        rc = lib.iff_field_features(
            flat.data_ptr(), n, (ctypes.c_longlong * 12)(*ptrs),
            (ctypes.c_int * len(dims))(*dims), sigma.data_ptr(),
            0 if app is None else app.data_ptr(), int(vec),
            BLOCKS_PER_SM * _build.sm_count(flat.device), stream)
        _build.check(rc, "field_features kernel launch")
        field_features.launches += 1
    return sigma, app


def _launch_backward(tables, dims, flat, dsigma, dapp, wanted):
    """Zeroed gradients of the ``wanted`` tables (12 flags), the kernel's
    sums added into them -> 12 tensors or None."""
    grads = [torch.zeros_like(a) if a is not None and want else None
             for a, want in zip(tables, wanted)]
    n = flat.shape[0]
    if n > 0 and any(g is not None for g in grads):
        lib = _build.load("field_features", _SIGNATURES)
        ptrs = [0 if a is None else a.data_ptr() for a in tables]
        gptrs = [0 if g is None else g.data_ptr() for g in grads]
        vec = _vec(dims, ptrs + [p for p in gptrs if p]
                   + ([] if dapp is None else [dapp.data_ptr()]))
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        rc = lib.iff_field_features_bwd(
            flat.data_ptr(), n, (ctypes.c_longlong * 12)(*ptrs),
            (ctypes.c_longlong * 12)(*gptrs),
            (ctypes.c_int * len(dims))(*dims), dsigma.data_ptr(),
            0 if dapp is None else dapp.data_ptr(), int(vec),
            BLOCKS_PER_SM * _build.sm_count(flat.device), stream)
        _build.check(rc, "field_features backward kernel launch")
        field_features_backward.launches += 1
    return grads


def _launch_coords_grad(tables, dims, flat, dsigma, dapp):
    """The gradient of sum(sigma * dsigma) (+ sum(app * dapp)) with respect
    to the coordinates flat [n, 3] -> [n, 3]."""
    n = flat.shape[0]
    dxyz = torch.empty((n, 3), dtype=torch.float32, device=flat.device)
    if n > 0:
        lib = _build.load("field_features", _SIGNATURES)
        ptrs = [0 if a is None else a.data_ptr() for a in tables]
        vec = _vec(dims, ptrs + ([] if dapp is None else [dapp.data_ptr()]))
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        rc = lib.iff_field_features_coords_grad(
            flat.data_ptr(), n, (ctypes.c_longlong * 12)(*ptrs),
            (ctypes.c_int * len(dims))(*dims), dsigma.data_ptr(),
            0 if dapp is None else dapp.data_ptr(), dxyz.data_ptr(), int(vec),
            BLOCKS_PER_SM * _build.sm_count(flat.device), stream)
        _build.check(rc, "field_features coordinate-gradient kernel launch")
        field_features_coords_grad.launches += 1
    return dxyz


class _FieldFeatures(torch.autograd.Function):
    """The kernel's forward and its hand-written backwards. Saves the
    coordinates and the 12 tables as given (None for the appearance tables
    of a density-only call); the backward launches the table kernel for
    the tables that require grad and the coordinate kernel when the
    coordinates do."""

    @staticmethod
    def forward(ctx, dims, with_app, flat, *tables):
        ctx.dims, ctx.with_app = dims, with_app
        ctx.save_for_backward(flat, *tables)
        sigma, app = _launch_forward(tables, dims, flat, with_app)
        return (sigma, app) if with_app else sigma

    @staticmethod
    def backward(ctx, dsigma, dapp=None):
        flat, *tables = ctx.saved_tensors
        dsigma = dsigma.contiguous()
        dapp = dapp.contiguous() if ctx.with_app else None
        grads = _launch_backward(tables, ctx.dims, flat, dsigma, dapp,
                                 ctx.needs_input_grad[3:])
        dxyz = (_launch_coords_grad(tables, ctx.dims, flat, dsigma, dapp)
                if ctx.needs_input_grad[2] else None)
        return (None, None, dxyz, *grads)


def field_features(config, params, xyz: torch.Tensor, with_app: bool = True):
    """(sigma feature [...], appearance products [..., sum(R_app)] or None
    without ``with_app``) of a TensorVMSplit field at normalized coords xyz
    [..., 3]. CPU tensors take the plain version; CUDA tensors launch the
    kernel (none for no samples) or raise. On CUDA, tables that require
    grad get their gradients from the backward kernel, and an ``xyz`` that
    requires grad from the coordinate-gradient kernel."""
    _check(config, params, xyz)
    if xyz.device.type == "cpu":
        return field_features_plain(params, xyz, with_app)
    if xyz.device.type != "cuda":
        raise ValueError(f"no field-feature kernel for {xyz.device}")
    tables, dims = kernel_layout(params, with_app)
    shape = xyz.shape[:-1]
    flat = xyz.reshape(-1, 3).contiguous()
    out = _FieldFeatures.apply(dims, with_app, flat, *tables)
    sigma, app = out if with_app else (out, None)
    sigma = sigma.reshape(shape)
    return sigma, None if app is None else app.reshape(shape + (dims[-1],))


def field_features_backward(config, params, xyz: torch.Tensor,
                            dsigma: torch.Tensor, dapp=None):
    """The backward kernel's wrapper: the gradients of sum(sigma * dsigma)
    (+ sum(app * dapp) when ``dapp`` [..., sum(R_app)] is given) with
    respect to the tables, for CUDA tensors -> {table name: (3
    gradients)}, the density tables and, with ``dapp``, the appearance
    ones. CPU tensors take ``field_features_backward_plain``."""
    _check(config, params, xyz)
    if xyz.device.type == "cpu":
        return field_features_backward_plain(params, xyz, dsigma, dapp)
    if xyz.device.type != "cuda":
        raise ValueError(f"no field-feature kernel for {xyz.device}")
    with_app = dapp is not None
    tables, dims = kernel_layout(params, with_app)
    flat = xyz.reshape(-1, 3).contiguous()
    dsigma = dsigma.reshape(-1).contiguous().float()
    if with_app:
        dapp = dapp.reshape(-1, dims[-1]).contiguous().float()
    grads = _launch_backward(tables, dims, flat, dsigma, dapp,
                             [a is not None for a in tables])
    names = TABLES if with_app else TABLES[:2]
    return {k: tuple(grads[3 * j:3 * j + 3]) for j, k in enumerate(names)}


def field_features_coords_grad(config, params, xyz: torch.Tensor,
                               dsigma: torch.Tensor, dapp=None):
    """The coordinate-gradient kernel's wrapper: the gradient of sum(sigma
    * dsigma) (+ sum(app * dapp) when ``dapp`` [..., sum(R_app)] is given)
    with respect to xyz [..., 3], for CUDA tensors -> [..., 3]. CPU
    tensors take ``field_features_coords_grad_plain``."""
    _check(config, params, xyz)
    if xyz.device.type == "cpu":
        return field_features_coords_grad_plain(params, xyz, dsigma, dapp)
    if xyz.device.type != "cuda":
        raise ValueError(f"no field-feature kernel for {xyz.device}")
    tables, dims = kernel_layout(params, dapp is not None)
    lead = xyz.shape[:-1]
    if dsigma.shape != lead or (dapp is not None
                                and dapp.shape != lead + (dims[-1],)):
        raise ValueError(
            f"upstream must be dsigma {tuple(lead)} and dapp "
            f"{tuple(lead) + (dims[-1],)}, got {tuple(dsigma.shape)} and "
            f"{None if dapp is None else tuple(dapp.shape)}")
    if any(u is not None and u.device != xyz.device for u in (dsigma, dapp)):
        raise ValueError(f"the upstream must lie on {xyz.device}")
    flat = xyz.reshape(-1, 3).contiguous()
    dsigma = dsigma.reshape(-1).contiguous().float()
    if dapp is not None:
        dapp = dapp.reshape(-1, dims[-1]).contiguous().float()
    return _launch_coords_grad(tables, dims, flat, dsigma, dapp).reshape(
        xyz.shape)


field_features.launches = 0
field_features_backward.launches = 0
field_features_coords_grad.launches = 0
