"""Meshes and the collectives the port's mesh layer issues.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (one process a
device: NCCL on the card, gloo on the CPU) or an :class:`AbstractMesh`,
which has the sizes and names of one and no processes behind it.  On an
abstract mesh every collective returns a tensor of the shape the real one
would give (values meaningless: the dry run traces it on fake tensors)
and sends nothing; the bytes it would move are recorded all the same.

Each call records its per-device bytes with the active counter
(``analysis.hlo``), by the convention of the JAX package's HLO analyzer:
an all-gather its output, a reduce-scatter its operand, an all-reduce
twice its operand (a ring's reduce-scatter and all-gather), a
point-to-point send its operand, a broadcast its operand.  Over an axis
of one device a collective is the identity, as GSPMD emits none there:
it returns its input (contiguous) with no backend call, no copy and no
record, so the dry run's counter and the step agree.

Gloo has no reduce-scatter: there it is an all-reduce of the operand and
this device's slice of the sum (the same values; the recorded bytes are
the reduce-scatter's, which is what the program asks for).
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..analysis import hlo

Axes = Union[str, Sequence[str]]


class AbstractMesh:
    """Sizes and axis names of a mesh, with no devices: the dry run's mesh
    when the job would need more ranks than there are."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} vs axes "
                             f"{tuple(axes)}")
        self.shape = tuple(int(n) for n in shape)
        self.mesh_dim_names = tuple(axes)
        self.device_type = "abstract"

    def size(self, mesh_dim=None) -> int:
        if mesh_dim is None:
            return math.prod(self.shape)
        return self.shape[_dim(self, mesh_dim)]

    def get_coordinate(self):
        return [0] * len(self.shape)

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape}, {self.mesh_dim_names})"


def is_abstract(mesh) -> bool:
    return isinstance(mesh, AbstractMesh)


def _dim(mesh, axis) -> int:
    return axis if isinstance(axis, int) \
        else tuple(mesh.mesh_dim_names).index(axis)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def coordinate(mesh, axis: str) -> int:
    """This process's index along ``axis`` (0 on an abstract mesh)."""
    return int(mesh.get_coordinate()[_dim(mesh, axis)])


def rank_at(mesh, axis: str, index: int) -> int:
    """Global rank of the device that shares this process's coordinates
    but ``index`` along ``axis``."""
    coord = list(mesh.get_coordinate())
    coord[_dim(mesh, axis)] = index
    return int(mesh.mesh[tuple(coord)])


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """The ``axis`` group's blocks of ``x`` joined along ``dim`` in
    coordinate order."""
    n = mesh.size(_dim(mesh, axis))
    x = x.contiguous()
    if n == 1:
        return x
    if is_abstract(mesh):
        parts = [x] * n
    else:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=mesh.get_group(axis))
    out = torch.cat(parts, dim)
    hlo.note_collective("all-gather", _nbytes(out))
    return out


def reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int = 0
                   ) -> torch.Tensor:
    """This device's block along ``dim`` of the sum of ``x`` over the
    ``axis`` group."""
    n = mesh.size(_dim(mesh, axis))
    if n == 1:
        return x.contiguous()
    hlo.note_collective("reduce-scatter", _nbytes(x))
    size = x.shape[dim] // n
    c = coordinate(mesh, axis)
    if is_abstract(mesh):
        return x.narrow(dim, 0, size).clone()
    group = mesh.get_group(axis)
    if dist.get_backend(group) == "gloo":
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y.narrow(dim, c * size, size).contiguous()
    parts = [p.contiguous() for p in x.chunk(n, dim)]
    out = torch.empty_like(parts[c])
    dist.reduce_scatter(out, parts, group=group)
    return out


def all_reduce(x: torch.Tensor, mesh, axes: Axes, op: str = "sum"
               ) -> torch.Tensor:
    """``x`` reduced (``"sum"`` or ``"max"``) over the devices that differ
    only along ``axes``, in place; returns ``x``."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    for a in _axes(axes):
        if mesh.size(_dim(mesh, a)) == 1:
            continue
        hlo.note_collective("all-reduce", 2 * _nbytes(x))
        if not is_abstract(mesh):
            dist.all_reduce(x, op=red, group=mesh.get_group(a))
    return x


def broadcast(x: torch.Tensor, mesh, axis: str, index: int) -> torch.Tensor:
    """``x`` of the device at ``index`` along ``axis``, in place on every
    device of the group; returns ``x``."""
    if mesh.size(_dim(mesh, axis)) == 1:
        return x
    hlo.note_collective("broadcast", _nbytes(x))
    if not is_abstract(mesh):
        dist.broadcast(x, src=rank_at(mesh, axis, index),
                       group=mesh.get_group(axis))
    return x


def shift(y: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Each device's ``y`` to the next along ``axis``: what the previous
    device sent (zeros on the first, which receives nothing; the last
    sends nothing), as ``lax.ppermute`` over the ring i -> i + 1 with the
    wrap-around dropped."""
    n, c = mesh.size(_dim(mesh, axis)), coordinate(mesh, axis)
    y = y.contiguous()
    got = torch.zeros_like(y)
    if n == 1:
        return got
    hlo.note_collective("collective-permute", _nbytes(y))
    if is_abstract(mesh):
        return got
    reqs = []
    if c + 1 < n:
        reqs.append(dist.isend(y, rank_at(mesh, axis, c + 1)))
    if c > 0:
        reqs.append(dist.irecv(got, rank_at(mesh, axis, c - 1)))
    for r in reqs:
        r.wait()
    return got
