"""Logical-axis sharding of the port, after ``repro/parallel/sharding.py``.

Parameters and activations are annotated with *logical* axis names
("embed", "mlp", "heads", "vocab", "experts", "batch", "seq", ...).  An
:class:`AxisRules` table maps those to mesh axes, and :meth:`AxisRules.spec`
gives the same partition spec as the JAX package's for the same leaf and
mesh.  Where JAX hands the spec to GSPMD, the port places tensors by it
itself: :func:`placements_for` turns it into DTensor placements on a
``DeviceMesh``, :func:`shard_of` cuts a device's block out of a whole
tensor, :func:`gather` joins the blocks again, and :func:`reduce_into`
sums a whole-size tensor over the mesh into a device's block (a gradient
reduce-scattered into its parameter's layout).  A mesh step gathers one
layer at a time, as GSPMD runs JAX's scanned layers: :func:`for_layers`
hands the model each stacked leaf as a :class:`Stacked` of its layers'
blocks, and :func:`layer` gathers a layer's weights inside its body
(:func:`gather_leaf`, whose backward reduces the layer's gradient into
its block).

A block is the one ``NamedSharding`` gives the device at the same mesh
coordinates: a dimension split over the mesh axes (a1, a2, ...) is cut
into size(a1) * size(a2) * ... blocks with a1 the major index.

Default rules implement FSDP("data") x TP("model") with EP on "model"
and the batch spread over ("pod","data") when a pod axis exists.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional, Sequence, Tuple, Union

import torch

from . import comm

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry a dimension: None (replicated), a mesh axis, or a tuple
    of mesh axes (major first), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


P = PartitionSpec


def _sizes(mesh) -> dict:
    """{axis: size} of a port mesh or of anything with JAX's
    ``axis_names`` and ``devices.shape``."""
    if mesh is None:
        return {}
    if hasattr(mesh, "mesh_dim_names"):
        return comm.axis_sizes(mesh)
    return dict(zip(mesh.axis_names, mesh.devices.shape))


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """logical axis name -> mesh axis (or tuple of mesh axes, or None)."""

    table: Tuple[Tuple[str, MeshAxes], ...]

    def get(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        for k, v in self.table:
            if k == logical:
                return v
        return None

    def spec(self, axes: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None,
             mesh=None) -> PartitionSpec:
        """PartitionSpec for logical `axes`.

        With `shape` and `mesh` given, any mapping whose mesh-axis product
        does not evenly divide the dimension falls back to replication
        (dropping mesh axes from the left, e.g. ("pod","data")->("data",))
        — tiny dims (4 heads, batch 1) must not break lowering.
        """
        sizes = _sizes(mesh)
        phys, used = [], set()
        for i, a in enumerate(axes):
            m = self.get(a)
            if m is None:
                phys.append(None)
                continue
            ms = (m,) if isinstance(m, str) else tuple(m)
            ms = tuple(x for x in ms if x not in used)
            if shape is not None and sizes:
                dim = shape[i]
                while ms:
                    prod = 1
                    for x in ms:
                        prod *= sizes[x]
                    if prod and dim % prod == 0:
                        break
                    ms = ms[1:]
            used.update(ms)
            phys.append(ms if len(ms) > 1 else (ms[0] if ms else None))
        return P(*phys)


def default_rules(multi_pod: bool = False, *, seq_shard_decode: bool = True,
                  act_shard: str = "seq") -> AxisRules:
    """FSDP(data) x TP(model); pod axis extends the data/batch dimension.

    act_shard="seq": Megatron-SP — the residual stream is sharded along
    sequence over the tensor axis.  act_shard="batch2d": the batch axis
    spreads over BOTH mesh axes instead (needs global_batch % 256 == 0).
    The port's steps use the rules for the layout of the state and the
    rows of the batch (``parallel.steps``).
    """
    if act_shard == "batch2d":
        batch = ("pod", "data", "model") if multi_pod \
            else ("data", "model")
        seq = None
    else:
        batch = ("pod", "data") if multi_pod else ("data",)
        seq = "model"
    table = [
        ("batch", batch),
        ("seq", seq),
        ("embed", "data"),          # FSDP: weight d_model axis over data
        ("mlp", "model"),
        ("heads", "model"),
        # kv heads: when batch occupies "data" (or kv doesn't divide) the
        # per-tensor fallback replicates, as before; for batch=1 decode
        # (long_500k) the idle data axis shards the kv heads instead.
        ("kv", "data"),
        ("vocab", "model"),
        ("experts", "model"),
        ("layers", None),
        ("kv_seq", "model" if seq_shard_decode else None),  # decode cache seq
        ("act_embed", None),        # activations' d_model axis
    ]
    return AxisRules(table=tuple(table))


# --------------------------------------------------------------------------
# Thread-local active (mesh, rules) context used by `constrain`.
# --------------------------------------------------------------------------

_ctx = threading.local()


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[AxisRules]):
    prev = getattr(_ctx, "state", None)
    _ctx.state = (mesh, rules) if mesh is not None else None
    try:
        yield
    finally:
        _ctx.state = prev


def active():
    return getattr(_ctx, "state", None)


def constrain(x, *logical: Optional[str]):
    """``x`` unchanged: a sharding constraint changes no value in JAX.
    Under an active mesh the spec is computed, so a logical name mapped
    to an axis the mesh lacks raises."""
    st = active()
    if st is not None:
        mesh, rules = st
        rules.spec(logical, shape=x.shape, mesh=mesh)
    return x


def _entries(e) -> Tuple[str, ...]:
    return () if e is None else (e,) if isinstance(e, str) else tuple(e)


# --------------------------------------------------------------------------
# The row groups of a mesh step (the MoE dispatch's global capacity).
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RowGroups:
    """The devices of a mesh step that hold distinct rows of the batch:
    one group a block of the batch axes that the rules cut the rows over
    (``axes``, major first), numbered in the order
    :func:`steps.batch_rows` cuts the rows, so group g holds rows
    [g * b, (g + 1) * b) of the global batch.  The devices of a group
    (along the other axes) hold the same rows."""

    mesh: object
    axes: Tuple[str, ...]

    @classmethod
    def of(cls, mesh, rules: AxisRules, rows: int) -> Optional["RowGroups"]:
        """The groups of a batch of ``rows`` rows on ``mesh``: the rules'
        "batch" axes less those they drop because they do not divide
        ``rows``; None where one group holds every row."""
        groups = cls(mesh, _entries(rules.spec(("batch",), (rows,), mesh)[0]))
        return groups if groups.count > 1 else None

    @property
    def count(self) -> int:
        sizes = comm.axis_sizes(self.mesh)
        return math.prod(sizes[a] for a in self.axes)

    @property
    def index(self) -> int:
        """This device's group."""
        sizes, g = comm.axis_sizes(self.mesh), 0
        for a in self.axes:
            g = g * sizes[a] + comm.coordinate(self.mesh, a)
        return g

    def below(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the groups before this one (one
        all-gather an axis of the groups)."""
        every = x[None]
        for a in reversed(self.axes):
            every = comm.all_gather(every, self.mesh, a, 0)
        return every[:self.index].sum(0)


# A module global, not a thread-local: on the card autograd runs the
# backward, and the forward that remat recomputes in it, on its own thread.
_row_groups: Optional[RowGroups] = None


@contextlib.contextmanager
def use_row_groups(groups: Optional[RowGroups]):
    """Set the row groups that :func:`row_groups` returns, for the span of
    one mesh step."""
    global _row_groups
    prev, _row_groups = _row_groups, groups
    try:
        yield
    finally:
        _row_groups = prev


def row_groups() -> Optional[RowGroups]:
    """The row groups of the mesh step running now; None off a mesh or
    where one group holds every row."""
    return _row_groups


def placements_for(axes: Sequence[Optional[str]], mesh, rules: AxisRules,
                   shape: Sequence[int]) -> tuple:
    """DTensor placements of a leaf, one a mesh dimension: ``Shard(d)``
    where the spec splits tensor dimension d over that mesh axis, else
    ``Replicate()``.  A dimension split over several axes is sharded on
    each of them, the major first, which is the block order of
    :func:`shard_of` when the axes come in the mesh's order (as the
    default rules' do)."""
    from torch.distributed.tensor import Replicate, Shard
    spec = rules.spec(axes, shape=shape, mesh=mesh)
    where = {a: d for d, e in enumerate(spec) for a in _entries(e)}
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh.mesh_dim_names)


def local_shape(spec: PartitionSpec, shape: Sequence[int], mesh
                ) -> Tuple[int, ...]:
    """Shape of one device's block of a ``shape`` tensor under ``spec``."""
    sizes = _sizes(mesh)
    return tuple(n // math.prod(sizes[a] for a in _entries(e))
                 for n, e in zip(shape, spec))


def shard_of(x: torch.Tensor, axes: Sequence[Optional[str]], mesh,
             rules: AxisRules) -> torch.Tensor:
    """This device's block of the whole tensor ``x`` (a copy)."""
    spec = rules.spec(axes, shape=x.shape, mesh=mesh)
    sizes = _sizes(mesh)
    for d, e in enumerate(spec):
        for a in _entries(e):
            n = x.shape[d] // sizes[a]
            x = x.narrow(d, comm.coordinate(mesh, a) * n, n)
    return x.clone()


def gather(local: torch.Tensor, axes: Sequence[Optional[str]], mesh,
           rules: AxisRules, shape: Sequence[int],
           keep: Tuple[str, ...] = ()) -> torch.Tensor:
    """The whole ``shape`` tensor from every device's block (all-gathers
    over the spec's axes, the minor axis of a dimension first); a
    dimension that an axis in ``keep`` splits (alone) stays cut."""
    spec = rules.spec(axes, shape=shape, mesh=mesh)
    x = local
    for d, e in enumerate(spec):
        if e in keep:
            continue
        for a in reversed(_entries(e)):
            x = comm.all_gather(x, mesh, a, d)
    return x


def reduce_into(g: torch.Tensor, axes: Sequence[Optional[str]], mesh,
                rules: AxisRules, keep: Tuple[str, ...] = (),
                shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """This device's block, in the layout of ``axes``, of the sum of the
    whole-size ``g`` over every device of the mesh: reduce-scatters over
    the axes that split the leaf (the major axis of a dimension first),
    then all-reduces over the axes that replicate it.  Along the axes in
    ``keep`` the devices hold parts of one computation, not copies: ``g``
    is already cut there as :func:`gather` with the same ``keep`` leaves
    the leaf (of whole ``shape``), and is not summed over them.  Axes of
    one device issue nothing (``comm``); ``g`` itself is never reduced in
    place."""
    spec = rules.spec(axes, shape=g.shape if shape is None else shape,
                      mesh=mesh)
    sizes, split, fresh = _sizes(mesh), set(keep), False
    for d, e in enumerate(spec):
        for a in _entries(e):
            if a not in keep and sizes[a] > 1:
                g, fresh = comm.reduce_scatter(g, mesh, a, d), True
            split.add(a)
    rest = tuple(a for a in mesh.mesh_dim_names
                 if a not in split and sizes[a] > 1)
    if rest:
        # the all-reduce works in place: never on the caller's ``g``
        g = comm.all_reduce(g.contiguous() if fresh else g.clone(
            memory_format=torch.contiguous_format), mesh, rest)
    return g


def rows_axes(axes: Sequence[Optional[str]]) -> Tuple[Optional[str], ...]:
    """``axes`` with every name but "batch" dropped: the port's steps
    split a batch, a cache or an input by rows only; a tensor-parallel
    step splits its residual stream by sequence after the embedding
    (``parallel.tensor``), and a decode cache stays whole in sequence."""
    return tuple(a if a == "batch" else None for a in axes)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where one leaf of ``shape`` with logical ``axes`` lives on
    ``mesh`` under ``rules``: the counterpart of a ``NamedSharding``."""

    mesh: object
    rules: AxisRules
    axes: Tuple[Optional[str], ...]
    shape: Tuple[int, ...]

    @property
    def spec(self) -> PartitionSpec:
        return self.rules.spec(self.axes, shape=self.shape, mesh=self.mesh)

    @property
    def local_shape(self) -> Tuple[int, ...]:
        return local_shape(self.spec, self.shape, self.mesh)

    @property
    def placements(self) -> tuple:
        return placements_for(self.axes, self.mesh, self.rules, self.shape)

    @property
    def copies(self) -> int:
        """Devices that hold the same block."""
        blocks = math.prod(self.shape[i] // n for i, n in
                           enumerate(self.local_shape)) if self.shape else 1
        return self.mesh.size() // blocks

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        return shard_of(x, self.axes, self.mesh, self.rules)

    def gather(self, local: torch.Tensor, keep: Tuple[str, ...] = ()
               ) -> torch.Tensor:
        return gather(local, self.axes, self.mesh, self.rules, self.shape,
                      keep)

    def reduce(self, g: torch.Tensor, keep: Tuple[str, ...] = ()
               ) -> torch.Tensor:
        return reduce_into(g, self.axes, self.mesh, self.rules, keep,
                           self.shape)

    def kept_shape(self, keep: Tuple[str, ...] = ()) -> Tuple[int, ...]:
        """The shape :meth:`gather` with ``keep`` gives: whole, but a
        dimension an axis in ``keep`` splits alone."""
        sizes = _sizes(self.mesh)
        return tuple(n // sizes[e] if e in keep else n
                     for n, e in zip(self.shape, self.spec))

    @property
    def stacked(self) -> int:
        """The leading "layers" dimensions of the leaf (0: not stacked)."""
        n = 0
        while n < len(self.axes) and self.axes[n] == "layers":
            n += 1
        return n

    def layer(self) -> "Layout":
        """The layout of one layer of a stacked leaf: the leaf's without
        its leading "layers" dimensions, which no mesh axis may split."""
        n = self.stacked
        if any(self.spec[:n]):
            raise ValueError(f"leaf {self.axes}: the rules split its layers "
                             f"({self.spec})")
        return Layout(self.mesh, self.rules, self.axes[n:], self.shape[n:])


def layouts(spec_tree, mesh, rules: AxisRules, rows_only: bool = False):
    """A :class:`Layout` for every ``ParamSpec`` of ``spec_tree`` (by rows
    only with ``rows_only``), in its nest."""
    from ..tree import tree_map
    return tree_map(lambda s: Layout(
        mesh, rules, rows_axes(s.axes) if rows_only else tuple(s.axes),
        tuple(s.shape)), spec_tree)


# --------------------------------------------------------------------------
# FSDP one layer at a time, as GSPMD runs JAX's scanned layers.
# --------------------------------------------------------------------------


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, lay, keep):
        ctx.lay, ctx.keep = lay, keep
        return lay.gather(block, keep)

    @staticmethod
    def backward(ctx, g):
        return ctx.lay.reduce(g, ctx.keep), None, None


def gather_leaf(block: torch.Tensor, lay: Layout,
                keep: Tuple[str, ...] = ()) -> torch.Tensor:
    """The leaf of layout ``lay`` whole (cut along ``keep``) from this
    device's ``block``: all-gathers over every other axis that splits it.
    Its gradient is reduced into the block as :meth:`Layout.reduce`
    reduces it: reduce-scattered over those axes, all-reduced over the
    axes that replicate the leaf."""
    return _Gather.apply(block, lay, keep)


@dataclasses.dataclass(frozen=True, eq=False)
class LayerBlock:
    """This device's block of one layer of a stacked leaf in a mesh step,
    with the layer's layout: what :func:`layer` gathers."""

    block: torch.Tensor
    layout: Layout
    keep: Tuple[str, ...]


class Stacked:
    """A stacked leaf in a mesh step: this device's block of each layer,
    one tensor a layer (``parts``, in the order of the leading "layers"
    dimensions ``lead``), each of the layer's layout ``layout``, indexed
    as the layer code indexes a stacked tensor: by the leading
    dimensions, down to one layer's :class:`LayerBlock`.  ``shape`` is
    the leaf's as the layer code sees it a layer at a time (whole, or cut
    along ``keep``); the leaf is never gathered whole."""

    def __init__(self, parts, layout: Layout, keep: Tuple[str, ...],
                 lead: Tuple[int, ...]):
        if len(parts) != math.prod(lead):
            raise ValueError(f"{len(parts)} layers for {lead}")
        self.parts, self.layout, self.keep, self.lead = \
            list(parts), layout, keep, tuple(lead)

    @property
    def shape(self) -> torch.Size:
        return torch.Size(self.lead + self.layout.kept_shape(self.keep))

    def __getitem__(self, i: int):
        if not 0 <= i < self.lead[0]:
            raise IndexError(i)
        if len(self.lead) == 1:
            return LayerBlock(self.parts[i], self.layout, self.keep)
        n = math.prod(self.lead[1:])
        return Stacked(self.parts[i * n:(i + 1) * n], self.layout,
                       self.keep, self.lead[1:])


# A module global, like the row groups: whether a mesh step is running,
# whose stacked leaves reach the layers only as LayerBlocks.
_in_blocks = False


@contextlib.contextmanager
def use_blocks(on: bool = True):
    """Mark the span of one mesh step: :func:`layer` then takes only
    :class:`LayerBlock` leaves."""
    global _in_blocks
    prev, _in_blocks = _in_blocks, on
    try:
        yield
    finally:
        _in_blocks = prev


def layer(tree):
    """One layer's weights as the layer code computes with them: in a mesh
    step each :class:`LayerBlock` gathered (:func:`gather_leaf`, inside
    the layer, so remat recomputes it); off a mesh step each tensor as it
    is (a view of the stacked tensor).  In a mesh step a tensor raises: a
    stacked leaf is never used whole."""
    if isinstance(tree, dict):
        return {k: layer(v) for k, v in tree.items()}
    if isinstance(tree, LayerBlock):
        return gather_leaf(tree.block, tree.layout, tree.keep)
    if _in_blocks:
        raise ValueError(f"a stacked leaf {tuple(tree.shape)} reached a "
                         f"layer of a mesh step without its layout")
    return tree


def for_layers(blocks, layouts_tree, keep: Tuple[str, ...] = (),
               live: Optional[list] = None):
    """The parameter tree the layer code takes in a mesh step, from this
    device's ``blocks``: each stacked leaf a :class:`Stacked` of its
    layers' blocks, every other leaf gathered (:func:`gather_leaf`).
    With ``live`` (a list) the layers' blocks and the other leaves are
    detached, made autograd inputs, and appended to it, one list a leaf:
    each layer is its own input, so its gradient is its own tensor."""
    from ..tree import leaves, unflatten
    out = []
    for x, lay in zip(leaves(blocks), leaves(layouts_tree), strict=True):
        n = lay.stacked
        parts = list(x.flatten(0, n - 1).unbind(0)) if n else [x]
        if live is not None:
            parts = [p.detach().requires_grad_() for p in parts]
            live.append(parts)
        out.append(Stacked(parts, lay.layer(), keep, lay.shape[:n]) if n
                   else gather_leaf(parts[0], lay, keep))
    return unflatten(blocks, out)
