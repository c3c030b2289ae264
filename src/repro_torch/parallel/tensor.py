"""Tensor parallelism over the "model" axis of a mesh step: Megatron's
column and row splits, placed where the JAX package's rules place the
leaves (``sharding.default_rules``: "heads", "mlp" and "vocab" on
"model").

A mesh step of the dense or VLM decoder whose batch the rules do not cut
over "model" (``steps``) gathers each parameter over every other axis
and hands the layer code the leaf's "model" block: wq (D, H/m, dh), wo
(H/m, dh, D), w_gate and w_up (D, F/m), w_down (F/m, D) and the embedding
(V/m, D).  A leaf the spec leaves whole over "model" (a dimension that
does not divide, wk, wv, the norm scales) stays whole.  The layer code
asks :meth:`TensorParallel.split_dim` whether its leaf is split, which
reads the leaf's spec and checks that the leaf is that block.

Between the split and the whole residual stream stand two autograd
functions over ``comm``, so the op counter counts their collectives:

* :func:`into_split`: the identity forward, an all-reduce over "model"
  backward (the input of a column split, and a whole leaf of which a
  device uses a slice);
* :func:`out_of_split`: an all-reduce over "model" forward (a row
  split's partial sums), the identity backward.

The logits stay cut by vocab: :func:`vocab_cross_entropy` takes the
global max and sum of exponentials and the target logit from the block
that owns it; :func:`gather_vocab` joins the blocks of a prefill's or a
decode's logits.

The context is a module global, not a thread-local, as
``sharding.use_row_groups``'s is, and is set only for the span of a mesh
step (:func:`use`).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from . import comm
from . import sharding as shd

AXIS = "model"


def _unstacked(axes, shape):
    """``axes`` and ``shape`` without the leading "layers" dimensions."""
    n = 0
    while n < len(axes) and axes[n] == "layers":
        n += 1
    return tuple(axes[n:]), tuple(shape[n:])


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The mesh, the axis, this device's coordinate on it and its size,
    and for each leaf's logical axes (without "layers") its whole shape
    and the dimension the axis splits (None: whole)."""

    mesh: object
    axis: str
    index: int
    size: int
    leaves: Tuple[Tuple[Tuple[Optional[str], ...], Tuple[int, ...],
                        Optional[int]], ...]

    @classmethod
    def of(cls, mesh, layouts) -> "TensorParallel":
        """The context of a step whose parameters lie in ``layouts`` (a
        tree of ``sharding.Layout``); raises where two leaves with the
        same logical axes differ in shape or split, or where "model"
        shares a dimension with another axis."""
        from ..tree import leaves
        table = {}
        for lay in leaves(layouts):
            axes, shape = _unstacked(lay.axes, lay.shape)
            spec = lay.spec[len(lay.axes) - len(axes):]
            dims = [d for d, e in enumerate(spec)
                    if AXIS in shd._entries(e)]
            if dims and spec[dims[0]] != AXIS:
                raise ValueError(f"leaf {lay.axes}: {AXIS!r} shares a "
                                 f"dimension ({spec})")
            entry = (shape, dims[0] if dims else None)
            if table.setdefault(axes, entry) != entry:
                raise ValueError(f"leaves with axes {axes} differ: "
                                 f"{table[axes]} and {entry}")
        return cls(mesh, AXIS, comm.coordinate(mesh, AXIS),
                   comm.axis_sizes(mesh)[AXIS],
                   tuple((a, s, d) for a, (s, d) in table.items()))

    def dim_of(self, axes: Sequence[Optional[str]]) -> Optional[int]:
        """The dimension the axis splits in leaves with logical ``axes``;
        None where they stay whole."""
        return self._entry(axes)[1]

    def split_dim(self, w: torch.Tensor, axes: Sequence[Optional[str]]
                  ) -> Optional[int]:
        """:meth:`dim_of` for the leaf ``w``, which must be this device's
        block of it (a split leaf that came whole raises)."""
        whole, dim = self._entry(axes)
        want = whole if dim is None else \
            whole[:dim] + (whole[dim] // self.size,) + whole[dim + 1:]
        if tuple(w.shape) != want:
            raise ValueError(f"leaf {tuple(axes)} has shape "
                             f"{tuple(w.shape)}, its block is {want}")
        return dim

    def _entry(self, axes):
        for a, shape, dim in self.leaves:
            if a == tuple(axes):
                return shape, dim
        raise KeyError(f"no leaf with axes {tuple(axes)}")

    def kv_heads(self, n_heads: int, n_kv: int) -> range:
        """The KV heads, in order, that this device's block of the
        ``n_heads`` query heads reads, laid out so that local query head j
        reads local KV head j // (local heads // KV heads), as a GQA
        kernel takes them: whole groups, or one head shared by the block.
        Raises NotImplementedError where neither the block nor a group
        divides the other."""
        hl, g = n_heads // self.size, n_heads // n_kv
        first = self.index * hl // g
        if hl % g == 0:
            return range(first, first + hl // g)
        if g % hl == 0:
            return range(first, first + 1)
        raise NotImplementedError(
            f"{hl} query heads a device over groups of {g}: neither divides "
            f"the other")


_active: Optional[TensorParallel] = None


@contextlib.contextmanager
def use(tp: Optional[TensorParallel]):
    """Set the context :func:`active` returns, for the span of one mesh
    step."""
    global _active
    prev, _active = _active, tp
    try:
        yield
    finally:
        _active = prev


def active() -> Optional[TensorParallel]:
    """The tensor-parallel context of the mesh step running now; None off
    a mesh and where the step keeps the whole gather."""
    return _active


def _all_reduce(x: torch.Tensor, tp: TensorParallel, op: str = "sum"
                ) -> torch.Tensor:
    """A reduced copy of ``x`` over the axis (``x`` itself on a size of
    1, with no collective)."""
    if tp.size == 1:
        return x
    return comm.all_reduce(x.clone(memory_format=torch.contiguous_format),
                           tp.mesh, tp.axis, op)


class _IntoSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


class _OutOfSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


def into_split(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """``x``; its gradient summed over the axis."""
    return _IntoSplit.apply(x, tp)


def out_of_split(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """``x`` summed over the axis; its gradient passed on whole."""
    return _OutOfSplit.apply(x, tp)


class _VocabCrossEntropy(torch.autograd.Function):
    """Mean CE over the rows with ``valid``, of logits cut by vocab:
    forward two all-reduces (the max; the sum of exponentials with the
    target logit), backward softmax minus one-hot on the local slice,
    with no collective."""

    @staticmethod
    def forward(ctx, logits, target, valid, tp):
        vl = logits.shape[-1]
        local = target - tp.index * vl
        own = valid & (local >= 0) & (local < vl)
        local = torch.where(own, local, 0)
        m = _all_reduce(logits.amax(-1), tp, "max")
        p = torch.exp(logits - m[:, None])
        hit = torch.where(own, logits.gather(1, local[:, None])[:, 0], 0.0)
        sums = _all_reduce(torch.stack([p.sum(-1), hit]), tp)
        p /= sums[0][:, None]
        count = valid.sum().clamp(min=1)
        nll = torch.log(sums[0]) + m - sums[1]
        ctx.save_for_backward(p, local, own, valid, count)
        return torch.where(valid, nll, 0.0).sum() / count

    @staticmethod
    def backward(ctx, g):
        p, local, own, valid, count = ctx.saved_tensors
        w = torch.where(valid, g / count, 0.0)
        grad = p * w[:, None]
        grad.scatter_add_(1, local[:, None],
                          torch.where(own, -w, 0.0)[:, None])
        return grad, None, None, None


def vocab_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                        tp: TensorParallel) -> torch.Tensor:
    """``common.cross_entropy`` of this device's vocab block of the
    logits (..., V/m): the same global mean over the labels >= 0, on
    every device of the axis."""
    flat = logits.float().reshape(-1, logits.shape[-1])
    labels = labels.reshape(-1)
    valid = labels >= 0
    return _VocabCrossEntropy.apply(flat, labels.long(), valid, tp)


def gather_vocab(logits: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The whole logits (..., V) from every device's vocab block."""
    if tp.size == 1:
        return logits
    return comm.all_gather(logits, tp.mesh, tp.axis, logits.dim() - 1)


def applies(cfg, mesh, rules: shd.AxisRules, rows: Optional[int]) -> bool:
    """Whether a mesh step of ``cfg`` splits its layers over "model": the
    dense and VLM decoders with GQA attention, on a mesh with a "model"
    axis of more than one device that the batch of ``rows`` rows (the
    rules' "batch" entry where not given) is not cut over."""
    if cfg.family not in ("dense", "vlm") or cfg.attn != "gqa" \
            or mesh is None or AXIS not in mesh.mesh_dim_names \
            or comm.axis_sizes(mesh)[AXIS] == 1:
        return False
    batch = rules.get("batch") if rows is None \
        else rules.spec(("batch",), (rows,), mesh)[0]
    return AXIS not in shd._entries(batch)
