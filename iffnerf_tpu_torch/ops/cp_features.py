"""The TensorCP field's features in one pass: ``cp_features``.

For each sample and each axis i it lerps line i's 2 corner rows at the
coordinate xyz[VEC_MODE[i]], multiplies the three lerps rank by rank,
sums the density ranks into the sigma feature and emits the appearance
products (before ``basis_mat``, which stays a ``torch.matmul`` in
``models/field.py``). This is what ``compute_densityfeature`` and
``compute_appfeature`` of the JAX package compute for TensorCP
(``iffnerf_tpu/models/field.py:383-389,484-489``), whose texel fetches are
the work of the Pallas kernel ``pallas_gather``
(``extra/pallas_gather_bench.py:46``; XLA gathers there) and whose
gradients XLA derives. On Hopper the kernel ``csrc/cp_features.cu`` lerps
the corner texels in registers: only sigma and the [N, R_app] products
reach device memory (the samplers' corner rows at TensoRF's CP setting
would be 16 GB an appearance axis). Its forward ("shared" route,
``iff_cp_features``) gives each block a column slice of the three lines
in shared memory (``forward_plan``: 32 columns where the slice fits, else
16, 8, ..., 1; ``forward_words``: 8 or 1 columns a lane): the warps
walk units of samples in step with every other slice's, compute each
sample's corners once into shared records, read a slot's words from the
slice only when its row changes and store the products evict-first; the
density slices' sums meet in a scratch, added in slice order by a second
kernel (no atomics: repeats are bit-equal). What holds it at a lego CP
step is its store stream (a row's lines come from nine SMs) and, nearly
as much, the walk's lerps. Lines longer than FWD_MAX_ROWS rows in all
take the first design ("l1" route, ``iff_cp_features_l1``: a group of
lanes a sample, its corner words read through L1); the launches are
counted in all and by route (``cp_features.launches_by_route``).

``cp_features`` launches the kernel for CUDA tensors and takes
``cp_features_plain`` (the grid samplers of ``ops/grid_sample.py``) for
CPU tensors. The semantics are ``grid_sample_1d``'s: ``align_corners=True``,
zeros padding, int32 corners clamped with validity flags; lines are
``[L_i, R]``, their lengths uneven after ``shrink``.

On CUDA the function is differentiable in the lines and in the
coordinates: an ``autograd.Function`` saves the coordinates and the lines
it was given. For the lines its backward launches ``iff_cp_features_bwd``
(the wrapper ``cp_features_backward``: a block's column slice of all three
lines accumulated in shared memory, each of its warps walking the upstream
that its lane 0 bulk-copies into the warp's ring; ``backward_plan`` and
``chunks`` split the work);
for the coordinates (iNeRF's pose gradient) ``iff_cp_features_coords_grad``
(the wrapper ``cp_features_coords_grad``: each warp streams units of
samples through its own bulk-copy ring, votes once a sample, leaves a stage
with no upstream at once and walks the live samples with its slot words in
registers; ``coords_plan`` picks the stage and the ring). Each launches
only when its inputs require grad. The plain versions,
``cp_features_backward_plain`` and ``cp_features_coords_grad_plain``, are
torch's autograd through the grid samplers on ``gather_rows_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from iffnerf_tpu_torch.ops import _build
from iffnerf_tpu_torch.ops.gather import gather_rows_plain
from iffnerf_tpu_torch.ops.grid_sample import grid_sample_1d

VEC_MODE = (2, 1, 0)
LINES = ("density_line", "app_line")

_P = ctypes.c_void_p
_LL = ctypes.POINTER(ctypes.c_longlong)
_I = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "iff_cp_features": [_P, ctypes.c_longlong, _LL, _I, _P, _P, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, _P],
    "iff_cp_features_l1": [_P, ctypes.c_longlong, _LL, _I, _P, _P, ctypes.c_int,
                           ctypes.c_int, _P],
    "iff_cp_features_bwd": [_P, ctypes.c_longlong, _LL, _LL, _I, _P, _P,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, _P, _P],
    "iff_cp_features_coords_grad": [_P, ctypes.c_longlong, _LL, _I, _P, _P, _P,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, _P, _P],
}
MAX_SMEM = 227 * 1024       # a block's shared memory
# The backward's split, as csrc/cp_features.cu (namespace bwd) lays out
# its shared memory: one block an SM of BWD_WARPS warps, each with a ring
# of 2 to 4 stages of BWD_RUN samples a group of lanes (a group is
# 1 << log_cw lanes, min(32 >> log_cw, BWD_MAX_GROUPS) a warp), taking
# units of BWD_UNIT samples from its column slice's queue.
BWD_MAX_ROWS = 28 * 1024    # L_0 + L_1 + L_2 at most (one column's sums in 112 KB)
BWD_WARPS, BWD_RUN, BWD_UNIT, BWD_MAX_GROUPS = 16, 8, 1024, 2
BWD_STAGES = (4, 3, 2)      # ring depths tried, deepest first
# The forward's split (namespace fwd): one block an SM of FWD_WARPS warps
# holds a column slice of the three lines beside each warp's corner
# records of a FWD_STAGE-sample stage (FWD_RECORD bytes a sample), its
# warps walking units of FWD_UNIT samples in turn with every other slice's.
# Longer lines than one column of FWD_MAX_ROWS rows take the first design.
FWD_WARPS, FWD_STAGE, FWD_UNIT, FWD_RECORD = 16, 32, 32, 48
FWD_MAX_ROWS = (MAX_SMEM - FWD_WARPS * FWD_STAGE * FWD_RECORD) // 4
# The coordinate gradient's split (namespace cgrad): one block an SM of
# COORDS_WARPS warps, each taking units of COORDS_UNIT samples from a queue
# and streaming their stages of COORDS_RUNS[0] samples (COORDS_RUNS[1] for
# appearance ranks too wide for it) through its own ring of 2 to 4 stages,
# beside its corner records (COORDS_RECORD bytes a sample, 8 samples).
COORDS_WARPS, COORDS_UNIT, COORDS_RECORD = 12, 64, 48
COORDS_RUNS = (8, 4)
COORDS_STAGES = (4, 3, 2)   # ring depths tried, deepest first


def cp_products(lines, xyz: torch.Tensor, gather=None) -> torch.Tensor:
    """The product of the three lines' lerps at xyz [..., 3], rank by
    rank, in the axis order 0, 1, 2; ``gather`` fetches the texels (None:
    the samplers' own, ``gather_rows``) -> [..., R]."""
    prod = None
    for i in range(3):
        line_feat = grid_sample_1d(lines[i], xyz[..., VEC_MODE[i]], gather)
        prod = line_feat if prod is None else prod * line_feat
    return prod


def cp_density(params, xyz: torch.Tensor, gather=None) -> torch.Tensor:
    """sigma feature [...] of a TensorCP field at xyz [..., 3]."""
    return torch.sum(cp_products(params["density_line"], xyz, gather), dim=-1)


def cp_app_products(params, xyz: torch.Tensor, gather=None) -> torch.Tensor:
    """Appearance products [..., R_app] of a TensorCP field at xyz [..., 3]
    (the input of ``basis_mat``)."""
    return cp_products(params["app_line"], xyz, gather)


def cp_features_plain(params, xyz: torch.Tensor, with_app: bool = True,
                      gather=None):
    """The kernel's function through the grid samplers, their texels
    fetched by ``gather``: (sigma feature [...], appearance products
    [..., R_app] or None)."""
    sigma = cp_density(params, xyz, gather)
    return sigma, cp_app_products(params, xyz, gather) if with_app else None


def _detached(params, with_app: bool, leaves: bool):
    """The lines a plain backward differentiates through -> (names,
    {name: 3 detached lines, leaves that require grad with ``leaves``})."""
    names = LINES if with_app else LINES[:1]
    return names, {k: tuple(a.detach().requires_grad_(leaves)
                            for a in params[k]) for k in names}


def cp_features_backward_plain(params, xyz: torch.Tensor, dsigma, dapp=None):
    """The backward's function in plain torch: autograd through the grid
    samplers on ``gather_rows_plain`` -> {"density_line": (3 gradients)}
    and, when ``dapp`` is given, {"app_line": ...} too."""
    names, lines = _detached(params, dapp is not None, True)
    with torch.enable_grad():
        sigma, app = cp_features_plain(lines, xyz.detach(), dapp is not None,
                                       gather_rows_plain)
        outs, ups = [sigma], [dsigma]
        if dapp is not None:
            outs.append(app)
            ups.append(dapp)
        flat = [a for k in names for a in lines[k]]
        grads = torch.autograd.grad(outs, flat, ups, allow_unused=True)
    grads = [torch.zeros_like(a) if g is None else g
             for a, g in zip(flat, grads)]
    return {k: tuple(grads[3 * j:3 * j + 3]) for j, k in enumerate(names)}


def cp_features_coords_grad_plain(params, xyz: torch.Tensor, dsigma,
                                  dapp=None) -> torch.Tensor:
    """The coordinate backward's function in plain torch: the gradient of
    sum(sigma * dsigma) (+ sum(app * dapp) when ``dapp`` is given) with
    respect to xyz [..., 3], the lines frozen, by autograd through the
    grid samplers on ``gather_rows_plain`` -> [..., 3]."""
    _, lines = _detached(params, dapp is not None, False)
    with torch.enable_grad():
        leaf = xyz.detach().requires_grad_()
        sigma, app = cp_features_plain(lines, leaf, dapp is not None,
                                       gather_rows_plain)
        outs, ups = [sigma], [dsigma]
        if dapp is not None:
            outs.append(app)
            ups.append(dapp)
        (grad,) = torch.autograd.grad(outs, [leaf], ups)
    return grad


def kernel_layout(params, with_app: bool):
    """The kernel's arguments from the lines' shapes -> (lines, dims):
    ``lines`` the 6 tensors (density lines, app lines; the app ones None
    without ``with_app``), ``dims`` (L_0, L_1, L_2, R_density, R_app), R_app
    0 without ``with_app``."""
    dens = list(params["density_line"])
    app = list(params["app_line"]) if with_app else [None] * 3
    lengths = [a.shape[0] for a in dens]
    for kind, group in (("density", dens), ("app", app)):
        if group[0] is None:
            continue
        if any(a.dim() != 2 or a.shape[1] != group[0].shape[1] for a in group):
            raise ValueError(f"the {kind} lines must be [L_i, R] of one rank R, "
                             f"got {[tuple(a.shape) for a in group]}")
        if [a.shape[0] for a in group] != lengths:
            raise ValueError(f"the {kind} lines' lengths "
                             f"{[a.shape[0] for a in group]} differ from the "
                             f"density lines' {lengths}")
    rd = dens[0].shape[1]
    ra = app[0].shape[1] if with_app else 0
    if rd < 1 or (with_app and ra < 1):
        raise ValueError(f"ranks must be at least 1, got {rd} and {ra}")
    return dens + app, lengths + [rd, ra]


def _check(config, params, xyz, with_app):
    if config.model_name != "TensorCP":
        raise ValueError(f"cp_features takes a TensorCP field, not "
                         f"{config.model_name}")
    if xyz.dtype != torch.float32 or xyz.shape[-1:] != (3,):
        raise ValueError(f"xyz must be [..., 3] float32, got {xyz.dtype} "
                         f"{tuple(xyz.shape)}")
    for name in LINES if with_app else LINES[:1]:
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
    """Whether the kernels take float4 words: both ranks multiples of 4,
    every pointer 16-byte aligned."""
    return dims[3] % 4 == 0 and dims[4] % 4 == 0 and all(p % 16 == 0
                                                         for p in ptrs)


def _ptrs(tensors):
    return [0 if a is None else a.data_ptr() for a in tensors]


def backward_smem(rows: int, log_cw: int, stages: int) -> int:
    """Shared memory of a backward block: each warp's ring of ``stages``
    stages (a 32 x BWD_RUN-word upstream box, which also takes the stage's
    corner records, each group's xyz and dsigma rows, and a barrier), and
    the sums of ``rows`` line rows x (1 << log_cw) columns."""
    groups = min(32 >> log_cw, BWD_MAX_GROUPS)
    stage = 32 * BWD_RUN * 4 + groups * BWD_RUN * 16 + 8
    return BWD_WARPS * stages * stage + rows * (4 << log_cw)


def backward_plan(dims, want_density: bool, want_app: bool):
    """(log2 of the columns a backward block owns, its ring depth): the
    widest power of two up to 32, and no wider than the columns asked for,
    at which the sums and a ring of BWD_STAGES' depths fit MAX_SMEM,
    the deepest that fits. Lines of more than BWD_MAX_ROWS rows in all
    raise ValueError; any fewer fit one column at the deepest ring."""
    rows = sum(dims[:3])
    cols = (dims[3] if want_density else 0) + (dims[4] if want_app else 0)
    if rows > BWD_MAX_ROWS:
        raise ValueError(
            f"the CP backward keeps a column of all three lines in shared "
            f"memory: {rows} rows need {rows * 4} B, more than "
            f"{BWD_MAX_ROWS * 4}")
    widest = 0
    while widest < 5 and (1 << widest) < cols:
        widest += 1
    for log_cw in range(widest, -1, -1):
        for stages in BWD_STAGES:
            if backward_smem(rows, log_cw, stages) <= MAX_SMEM:
                return log_cw, stages
    raise AssertionError(f"no backward plan for {rows} rows")


def chunks(n: int, slices: int, sms: int, unit: int, warps: int) -> int:
    """Blocks a column slice (the grid's y) for ``n`` samples and
    ``slices`` slices on a card of ``sms`` SMs: as many as fill one wave of
    one block an SM, and no more than give each of a block's ``warps``
    warps a unit of ``unit`` samples; at least one. The backward's with
    BWD_UNIT and BWD_WARPS, the forward's with FWD_UNIT and FWD_WARPS."""
    units = -(-n // unit)
    return max(1, min(sms // slices, -(-units // warps), 65535))


def forward_smem(rows: int, log_cw: int) -> int:
    """Shared memory of a forward block: each warp's corner records of a
    stage and the slice of ``rows`` line rows x (1 << log_cw) columns."""
    return FWD_WARPS * FWD_STAGE * FWD_RECORD + rows * (4 << log_cw)


def forward_plan(dims, with_app: bool):
    """The forward's route and the log2 of the columns a block owns:
    ("shared", the widest power of two up to 32, no wider than the columns,
    whose slice fits MAX_SMEM beside the records), or ("l1", None) for
    lines of more than FWD_MAX_ROWS rows in all, which take the first
    design (a group of lanes a sample, its corner rows read through L1)."""
    rows = sum(dims[:3])
    cols = dims[3] + (dims[4] if with_app else 0)
    widest = 0
    while widest < 5 and (1 << widest) < cols:
        widest += 1
    for log_cw in range(widest, -1, -1):
        if forward_smem(rows, log_cw) <= MAX_SMEM:
            return "shared", log_cw
    return "l1", None


def forward_words(dims, log_cw: int, aligned: bool) -> int:
    """Columns a lane of the forward's shared route takes: 8 (two float4
    words) where both ranks are multiples of 8, a block owns at least 8
    columns and every pointer is 16-byte aligned, else 1."""
    if aligned and dims[3] % 8 == 0 and dims[4] % 8 == 0 and 1 << log_cw >= 8:
        return 8
    return 1


def coords_smem(ra: int, run: int, stages: int) -> int:
    """Shared memory of a coordinate-gradient block: each warp's ring of
    ``stages`` stages of ``run`` samples (xyz, dsigma and ``ra`` dapp words
    a sample, and a barrier) and its corner records of 8 samples."""
    return COORDS_WARPS * (stages * (run * (16 + 4 * ra) + 8)
                           + max(COORDS_RUNS) * COORDS_RECORD)


def coords_plan(dims, with_app: bool):
    """(samples a stage, ring depth) of the coordinate gradient: the
    longest stage of COORDS_RUNS at the deepest ring of COORDS_STAGES
    whose blocks fit MAX_SMEM; appearance ranks too wide for two stages of
    the shortest raise ValueError."""
    ra = dims[4] if with_app else 0
    for run in COORDS_RUNS:
        for stages in COORDS_STAGES:
            if coords_smem(ra, run, stages) <= MAX_SMEM:
                return run, stages
    raise ValueError(
        f"the CP coordinate gradient streams whole upstream rows through "
        f"shared memory: {ra} appearance ranks need "
        f"{coords_smem(ra, COORDS_RUNS[-1], COORDS_STAGES[-1])} B, more than "
        f"{MAX_SMEM}")


def _launch_forward(lines, dims, flat, with_app):
    """sigma [n] and the appearance products [n, R_app] (None without
    ``with_app``) through the route ``forward_plan`` picks: "shared"
    (with more than one density slice, a scratch of their sums) or
    "l1"."""
    n = flat.shape[0]
    sigma = torch.empty(n, dtype=torch.float32, device=flat.device)
    app = (torch.empty((n, dims[4]), dtype=torch.float32, device=flat.device)
           if with_app else None)
    if n > 0:
        route, log_cw = forward_plan(dims, with_app)
        lib = _build.load("cp_features", _SIGNATURES)
        ptrs = _ptrs(lines)
        vec = _vec(dims, ptrs + [flat.data_ptr()]
                   + ([] if app is None else [app.data_ptr()]))
        args = (flat.data_ptr(), n, (ctypes.c_longlong * 6)(*ptrs),
                (ctypes.c_int * 5)(*dims), sigma.data_ptr(),
                0 if app is None else app.data_ptr())
        sms = _build.sm_count(flat.device)
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        if route == "shared":
            slices = -(-(dims[3] + dims[4]) >> log_cw)
            dens_slices = -(-dims[3] >> log_cw)
            part = (torch.empty((dens_slices, n), dtype=torch.float32,
                                device=flat.device) if dens_slices > 1 else None)
            rc = lib.iff_cp_features(
                *args, forward_words(dims, log_cw, vec), log_cw,
                chunks(n, slices, sms, FWD_UNIT, FWD_WARPS),
                0 if part is None else part.data_ptr(), sms,
                stream)
        else:
            rc = lib.iff_cp_features_l1(*args, int(vec), sms, stream)
        _build.check(rc, f"cp_features kernel launch ({route} route)")
        cp_features.launches += 1
        cp_features.launches_by_route[route] += 1
    return sigma, app


def _launch_backward(lines, dims, flat, dsigma, dapp, wanted):
    """Gradients of the ``wanted`` lines (6 flags) -> 6 tensors or None.
    The kernel adds a whole kind's sums, so each line of a kind with a
    wanted line gets a zeroed gradient, and those not wanted are dropped."""
    want_d = any(wanted[:3])
    want_a = dapp is not None and any(wanted[3:])
    full = [torch.zeros_like(a) if a is not None
            and (want_d if j < 3 else want_a) else None
            for j, a in enumerate(lines)]
    n = flat.shape[0]
    if n > 0 and (want_d or want_a):
        log_cw, stages = backward_plan(dims, want_d, want_a)
        lib = _build.load("cp_features", _SIGNATURES)
        cols = (dims[3] if want_d else 0) + (dims[4] if want_a else 0)
        slices = -(-cols >> log_cw)
        blocks = chunks(n, slices, _build.sm_count(flat.device), BWD_UNIT, BWD_WARPS)
        queue = torch.zeros(slices, dtype=torch.int32, device=flat.device)
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        rc = lib.iff_cp_features_bwd(
            flat.data_ptr(), n, (ctypes.c_longlong * 6)(*_ptrs(lines)),
            (ctypes.c_longlong * 6)(*_ptrs(full)), (ctypes.c_int * 5)(*dims),
            dsigma.data_ptr() if want_d else 0,
            dapp.data_ptr() if want_a else 0, int(want_d), int(want_a),
            log_cw, stages, blocks, queue.data_ptr(), stream)
        _build.check(rc, "cp_features backward kernel launch")
        cp_features_backward.launches += 1
    return [g if want else None for g, want in zip(full, wanted)]


def _launch_coords_grad(lines, dims, flat, dsigma, dapp):
    """The gradient of sum(sigma * dsigma) (+ sum(app * dapp)) with respect
    to the coordinates flat [n, 3] -> [n, 3]."""
    n = flat.shape[0]
    dxyz = torch.empty((n, 3), dtype=torch.float32, device=flat.device)
    if n > 0:
        run, stages = coords_plan(dims, dapp is not None)
        lib = _build.load("cp_features", _SIGNATURES)
        ptrs = _ptrs(lines)
        vec = _vec(dims, ptrs + [flat.data_ptr()]
                   + ([] if dapp is None else [dapp.data_ptr()]))
        units = -(-n // COORDS_UNIT)
        blocks = max(1, min(_build.sm_count(flat.device),
                            -(-units // COORDS_WARPS)))
        queue = torch.zeros(1, dtype=torch.int32, device=flat.device)
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        rc = lib.iff_cp_features_coords_grad(
            flat.data_ptr(), n, (ctypes.c_longlong * 6)(*ptrs),
            (ctypes.c_int * 5)(*dims), dsigma.data_ptr(),
            0 if dapp is None else dapp.data_ptr(), dxyz.data_ptr(), int(vec),
            run, stages, blocks, queue.data_ptr(), stream)
        _build.check(rc, "cp_features coordinate-gradient kernel launch")
        cp_features_coords_grad.launches += 1
    return dxyz


class _CPFeatures(torch.autograd.Function):
    """The kernel's forward and its hand-written backwards. Saves the
    coordinates and the 6 lines as given (None for the appearance lines of
    a density-only call); the backward launches the line kernel for the
    lines that require grad and the coordinate kernel when the coordinates
    do."""

    @staticmethod
    def forward(ctx, dims, with_app, flat, *lines):
        ctx.dims, ctx.with_app = dims, with_app
        ctx.save_for_backward(flat, *lines)
        sigma, app = _launch_forward(lines, dims, flat, with_app)
        return (sigma, app) if with_app else sigma

    @staticmethod
    def backward(ctx, dsigma, dapp=None):
        flat, *lines = ctx.saved_tensors
        dsigma = dsigma.contiguous()
        dapp = dapp.contiguous() if ctx.with_app else None
        grads = _launch_backward(lines, ctx.dims, flat, dsigma, dapp,
                                 ctx.needs_input_grad[3:])
        dxyz = (_launch_coords_grad(lines, ctx.dims, flat, dsigma, dapp)
                if ctx.needs_input_grad[2] else None)
        return (None, None, dxyz, *grads)


def cp_features(config, params, xyz: torch.Tensor, with_app: bool = True):
    """(sigma feature [...], appearance products [..., R_app] or None
    without ``with_app``) of a TensorCP field at normalized coords xyz
    [..., 3]. CPU tensors take the plain version; CUDA tensors launch the
    kernel (none for no samples) or raise. On CUDA, lines that require grad
    get their gradients from the backward kernel, and an ``xyz`` that
    requires grad from the coordinate-gradient kernel."""
    _check(config, params, xyz, with_app)
    if xyz.device.type == "cpu":
        return cp_features_plain(params, xyz, with_app)
    if xyz.device.type != "cuda":
        raise ValueError(f"no CP feature kernel for {xyz.device}")
    lines, dims = kernel_layout(params, with_app)
    if torch.is_grad_enabled() and any(a is not None and a.requires_grad
                                       for a in lines):
        # the backward's refusal before the forward's launch, so that no
        # call under grad fails only at its backward
        backward_plan(dims, True, with_app)
    if torch.is_grad_enabled() and xyz.requires_grad:
        coords_plan(dims, with_app)
    shape = xyz.shape[:-1]
    flat = xyz.reshape(-1, 3).contiguous()
    out = _CPFeatures.apply(dims, with_app, flat, *lines)
    sigma, app = out if with_app else (out, None)
    sigma = sigma.reshape(shape)
    return sigma, None if app is None else app.reshape(shape + (dims[4],))


def _flat_upstream(xyz, dims, dsigma, dapp):
    lead = xyz.shape[:-1]
    if dsigma.shape != lead or (dapp is not None
                                and dapp.shape != lead + (dims[4],)):
        raise ValueError(
            f"upstream must be dsigma {tuple(lead)} and dapp "
            f"{tuple(lead) + (dims[4],)}, got {tuple(dsigma.shape)} and "
            f"{None if dapp is None else tuple(dapp.shape)}")
    if any(u is not None and (u.device != xyz.device or u.dtype != torch.float32)
           for u in (dsigma, dapp)):
        raise ValueError(f"the upstream must be float32 on {xyz.device}")
    flat = xyz.reshape(-1, 3).contiguous()
    dsigma = dsigma.reshape(-1).contiguous()
    if dapp is not None:
        dapp = dapp.reshape(-1, dims[4]).contiguous()
    return flat, dsigma, dapp


def cp_features_backward(config, params, xyz: torch.Tensor,
                         dsigma: torch.Tensor, dapp=None):
    """The backward kernel's wrapper: the gradients of sum(sigma * dsigma)
    (+ sum(app * dapp) when ``dapp`` [..., R_app] is given) with respect to
    the lines, for CUDA tensors -> {"density_line": (3 gradients)} and,
    with ``dapp``, {"app_line": ...}. CPU tensors take
    ``cp_features_backward_plain``."""
    with_app = dapp is not None
    _check(config, params, xyz, with_app)
    if xyz.device.type == "cpu":
        return cp_features_backward_plain(params, xyz, dsigma, dapp)
    if xyz.device.type != "cuda":
        raise ValueError(f"no CP feature kernel for {xyz.device}")
    lines, dims = kernel_layout(params, with_app)
    backward_plan(dims, True, with_app)
    flat, dsigma, dapp = _flat_upstream(xyz, dims, dsigma, dapp)
    grads = _launch_backward(lines, dims, flat, dsigma, dapp,
                             [a is not None for a in lines])
    names = LINES if with_app else LINES[:1]
    return {k: tuple(grads[3 * j:3 * j + 3]) for j, k in enumerate(names)}


def cp_features_coords_grad(config, params, xyz: torch.Tensor,
                            dsigma: torch.Tensor, dapp=None):
    """The coordinate-gradient kernel's wrapper: the gradient of sum(sigma
    * dsigma) (+ sum(app * dapp) when ``dapp`` [..., R_app] is given) with
    respect to xyz [..., 3], for CUDA tensors -> [..., 3]. CPU tensors take
    ``cp_features_coords_grad_plain``."""
    with_app = dapp is not None
    _check(config, params, xyz, with_app)
    if xyz.device.type == "cpu":
        return cp_features_coords_grad_plain(params, xyz, dsigma, dapp)
    if xyz.device.type != "cuda":
        raise ValueError(f"no CP feature kernel for {xyz.device}")
    lines, dims = kernel_layout(params, with_app)
    flat, dsigma, dapp = _flat_upstream(xyz, dims, dsigma, dapp)
    return _launch_coords_grad(lines, dims, flat, dsigma, dapp).reshape(
        xyz.shape)


cp_features.launches = 0
cp_features.launches_by_route = {"shared": 0, "l1": 0}
cp_features_backward.launches = 0
cp_features_coords_grad.launches = 0
