"""A 1-D data mesh over ``torch.distributed``: rays are the parallel unit.

The JAX package shards the ray axis of its batched computations over a
``Mesh(('data',))`` of devices: parameters replicated, rays split, the
reductions made collectives. Here a mesh is a process group of ranks, one
device each (NCCL on the card, gloo on the CPU). The whole ray set arrives
on every rank, as JAX's callers pass it; rank ``r`` of ``s`` works on rows
``[r n / s, (r + 1) n / s)``, and per-ray results are all-gathered, so every
rank returns what the unsharded call returns.

``make_mesh`` registers its mesh under its axis name, and ``pmax``,
``psum`` and ``all_gather`` take that name (or a mesh), as JAX's
collectives take the axis that ``shard_map`` binds. Without a started
process group ``make_mesh`` gives a one-process mesh, whose collectives
return their input. The JAX package's ``get_shard_map``, a shim over JAX
versions, has no counterpart.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a 1-D mesh: its ``group`` (None for a
    one-process mesh), ``size`` ranks, this process's ``rank`` in it, the
    ``axis`` name and the ``device`` its collectives' tensors live on."""

    group: object
    size: int
    rank: int
    axis: str
    device: torch.device


_AXES: dict[str, Mesh] = {}


def make_mesh(devices=None, axis: str = "data", group=None) -> Mesh:
    """The mesh of ``group`` (the default process group when None), on
    axis ``axis``, registered under that name. ``devices`` is this rank's
    device (by default the bound CUDA device under NCCL or, without a
    group, where there is a card; else the CPU)."""
    if group is None and not dist.is_initialized():
        if devices is None:
            devices = (torch.device("cuda", torch.cuda.current_device())
                       if torch.cuda.is_available() else "cpu")
        mesh = Mesh(None, 1, 0, axis, torch.device(devices))
    else:
        group = dist.group.WORLD if group is None else group
        if devices is None:
            nccl = dist.get_backend(group) == "nccl"
            devices = (torch.device("cuda", torch.cuda.current_device())
                       if nccl else "cpu")
        mesh = Mesh(group, dist.get_world_size(group), dist.get_rank(group),
                    axis, torch.device(devices))
    _AXES[axis] = mesh
    return mesh


@contextlib.contextmanager
def bound(mesh: Mesh):
    """Binds ``mesh`` to its axis name while open, as ``shard_map`` binds
    its mesh's axes for the function it maps, and restores the binding it
    found."""
    before = _AXES.get(mesh.axis)
    _AXES[mesh.axis] = mesh
    try:
        yield mesh
    finally:
        if before is None:
            del _AXES[mesh.axis]
        else:
            _AXES[mesh.axis] = before


def mesh_of(axis) -> Mesh:
    """The mesh registered under the axis name ``axis`` (a mesh is taken
    as it is)."""
    if isinstance(axis, Mesh):
        return axis
    try:
        return _AXES[axis]
    except KeyError:
        raise NameError(f"unbound axis name: {axis!r} (make_mesh binds "
                        f"it)") from None


def pad_to_multiple(arr, multiple: int, axis: int = 0):
    """Pad the tensor ``arr`` along ``axis`` to a multiple by repeating
    its last entry (JAX's ``mode="edge"``); returns (padded, orig_len)."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    last = arr.narrow(axis, n - 1, 1)
    return torch.cat([arr, last.expand(
        *[rem if d == axis % arr.dim() else -1
          for d in range(arr.dim())])], dim=axis), n


def is_lead(mesh: Mesh | None) -> bool:
    """Whether this process logs and writes files: it has no mesh, or it
    is its mesh's rank 0."""
    return mesh is None or mesh.rank == 0


def lead_only(mesh: Mesh | None, fn):
    """``fn`` where ``is_lead(mesh)``, else a function that does nothing."""
    return fn if is_lead(mesh) else _nothing


def _nothing(*args, **kwargs) -> None:
    pass


def shard_bounds(mesh: Mesh, n: int) -> tuple[int, int]:
    """This rank's rows of ``n``: [r n / s, (r + 1) n / s)."""
    return mesh.rank * n // mesh.size, (mesh.rank + 1) * n // mesh.size


def shard_rays(mesh: Mesh, rays, axis: str = "data"):
    """This rank's rows of a [N, ...] ray array; N must divide by the
    mesh size (use pad_to_multiple first). ``axis`` is accepted for the
    JAX signature; a mesh has one."""
    n = rays.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rays do not divide over {mesh.size} ranks")
    lo, hi = shard_bounds(mesh, n)
    return rays[lo:hi]


def _broadcast(mesh: Mesh, t: torch.Tensor) -> None:
    """Rank 0's values into ``t`` on every rank, in place (through the
    mesh's device when ``t`` lies elsewhere, as NCCL needs)."""
    if mesh.group is None:
        return
    src = dist.get_global_rank(mesh.group, 0)
    buf = t.detach()
    if buf.device != mesh.device or not buf.is_contiguous():
        buf = buf.to(mesh.device).contiguous()
        dist.broadcast(buf, src, group=mesh.group)
        t.detach().copy_(buf)
    else:
        dist.broadcast(buf, src, group=mesh.group)


def _tensors(tree, strict: bool):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v, strict)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v, strict)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name), strict)
    elif strict:
        raise TypeError(f"replicate takes trees of tensors, got "
                        f"{type(tree).__name__}")


def replicate(mesh: Mesh, tree):
    """Rank 0's values of every tensor of a nested dict / list / tuple /
    dataclass, broadcast in place on every rank; returns the tree."""
    for t in _tensors(tree, strict=True):
        _broadcast(mesh, t)
    return tree


def replicate_arrays(mesh: Mesh, tree):
    """``replicate`` of only the tensor leaves: other leaves (an
    optimizer's counts, flags) are left as they are."""
    for t in _tensors(tree, strict=False):
        _broadcast(mesh, t)
    return tree


def _all_reduce(x: torch.Tensor, axis, op) -> torch.Tensor:
    mesh = mesh_of(axis)
    if mesh.group is None:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=mesh.group)
    return out


def pmax(x: torch.Tensor, axis_name) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks of the axis."""
    return _all_reduce(x, axis_name, dist.ReduceOp.MAX)


def psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    """The elementwise sum of ``x`` over the ranks of the axis."""
    return _all_reduce(x, axis_name, dist.ReduceOp.SUM)


def all_gather(x: torch.Tensor, axis_name) -> torch.Tensor:
    """The ranks' equal-sized ``x``, concatenated in rank order along dim 0
    (``jax.lax.all_gather(..., tiled=True)``)."""
    mesh = mesh_of(axis_name)
    if mesh.group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)
