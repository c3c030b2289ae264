"""Tensor and sequence parallelism over the "model" axis of a mesh step:
Megatron's column and row splits, placed where the JAX package's rules
place the leaves (``sharding.default_rules``: "heads", "mlp" and "vocab"
on "model"), and the residual stream split by rows between them where
the rules place "seq" on "model" (``act_shard="seq"``, Megatron-SP).

A mesh step of the dense, VLM, MoE or hybrid decoder (GQA or MLA
attention) or of the encoder-decoder whose batch the rules do not cut
over "model" (``steps``, :func:`applies`) gathers each parameter over
every other axis, a layer at a time (``sharding.layer``), and hands the
layer code the leaf's "model" block: wq (D, H/m, dh), wo (H/m, dh, D),
MLA's wq_b (q_lora, H/m, dq) or wq (D, H/m, dq) and wkv_b (kv_lora, H/m,
dk + dv), w_gate and w_up (D, F/m), w_down (F/m, D), the embedding (V/m,
D), a MoE layer's routed experts (E/m, D, F) and (E/m, F, D), expert
parallelism as the rules place "experts" (``models.moe``), and a Mamba2
layer's gated-norm scale (d_inner/m,) and out_proj (d_inner/m, D), the
channels of its h/m heads (``models.ssm``); the encoder-decoder's
cross-attention takes wq and wo as its self-attention does
(``models.encdec``).  A leaf the spec leaves whole over
"model" (a dimension that does not divide, wk, wv, MLA's wq_a and wkv_a,
the norm scales, the router, Mamba2's A_log, D and dt_bias) stays whole.
Mamba2's in_proj, conv_w and conv_b fuse z | x | B | C | dt (x | B | C
in the conv) on one "mlp" axis whose blocks do not fall on the heads:
the step gathers them whole over "model" too (their ``keep`` is ``()``,
:data:`WHOLE_OVER_MODEL`, :func:`keeps`), their gradients
reduce-scattered back into the blocks JAX's rules store, and the layer
slices its heads' columns.  The layer code asks
:meth:`TensorParallel.split_dim` whether its leaf is split, which reads
the leaf's spec (and its keep) and checks that the leaf is that block.

**The stream.**  The step decides once a call, from the rules' spec of
the stream's (B, S, D) (:meth:`TensorParallel.for_stream`, the
counterpart of JAX's constraint to ``("batch", "seq", "act_embed")``),
whether a device holds rows [i S/m, (i + 1) S/m) of it between the
sublayers (:func:`seq_split`).  Where S does not divide the axis (a
decode's one row, an odd prompt) the spec drops "model" and the stream
stays whole on every device of the axis.  The encoder-decoder has two
streams of their own lengths, its encoder's frames and its decoder's
tokens: each decides for itself (``models.encdec``), as JAX's spec does
for each of its constraints.  The collectives between the
split and the stream are autograd functions over ``comm``, so the op
counter counts them:

* stream whole: :func:`into_split`, the identity forward and an
  all-reduce backward (the input of a column split); :func:`out_of_split`,
  an all-reduce forward (a row split's partial sums), the identity
  backward;
* stream split: :func:`gather_seq`, an all-gather of the rows forward
  and a reduce-scatter backward (the input of a column split);
  :func:`scatter_seq`, a reduce-scatter forward (a row split's partial
  sums, each device keeping its rows) and an all-gather backward;
  :func:`split_seq`, a device's rows of a whole result forward and an
  all-gather backward.

A whole leaf that a device uses on a part of the work (wk and wv sliced
by KV heads; MLA's wq_a, wkv_a and their norms, which feed this device's
heads; under a split stream the norm scales, used on this device's
rows) enters through :func:`into_split`, so its gradient is summed over
the axis.  A layer whose weights the spec leaves whole computes whole on
every device of the axis, as without the split: from the gathered
sequence (``gather_seq(..., copies=True)``) to its whole output, of
which :func:`split_seq` keeps this device's rows (its backward
all-gathers the rows' gradients, so every device differentiates the
whole layer and its weights' gradients need no sum).

The logits stay cut by vocab: :func:`vocab_cross_entropy` takes the
global max and sum of exponentials and the target logit from the block
that owns it; :func:`gather_vocab` joins the blocks of a prefill's or a
decode's logits.  Under a split stream the unembedding takes the
gathered sequence, so the loss sees logits (B, S, V/m); JAX's spec of
the logits gives "model" to "seq" first and leaves "vocab" whole, (B,
S/m, V): the same values, and the same size a device.

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
# the leaves (by name) of a hybrid model that a tensor-parallel step
# gathers whole over "model" as well: Mamba2's fused input projection and
# conv, whose "mlp" blocks do not fall on the heads (``models.ssm``)
WHOLE_OVER_MODEL = ("in_proj", "conv_w", "conv_b")
# the logical axes of the residual stream (B, S, D), as JAX constrains it
STREAM_AXES = ("batch", "seq", "act_embed")


def _unstacked(axes, shape):
    """``axes`` and ``shape`` without the leading "layers" dimensions."""
    n = 0
    while n < len(axes) and axes[n] == "layers":
        n += 1
    return tuple(axes[n:]), tuple(shape[n:])


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The mesh, the axis, this device's coordinate on it and its size,
    for each leaf's logical axes (without "layers") its whole shape and
    the dimension the axis splits (None: whole), the step's rules, and
    whether this call's residual stream is split by rows (``seq``)."""

    mesh: object
    axis: str
    index: int
    size: int
    leaves: Tuple[Tuple[Tuple[Optional[str], ...], Tuple[int, ...],
                        Optional[int]], ...]
    rules: Optional[shd.AxisRules] = None
    seq: bool = False

    @classmethod
    def of(cls, mesh, layouts, keeps=None) -> "TensorParallel":
        """The context of a step whose parameters lie in ``layouts`` (a
        tree of ``sharding.Layout``), one entry a leaf's logical axes and
        whole shape: leaves with the same axes may differ in shape (a MoE
        model's dense and shared SwiGLUs), as long as their blocks do, so
        that a block names its leaf (:meth:`split_dim`).  ``keeps`` (one
        a leaf, in flatten order; :func:`keeps`) names the leaves the step
        gathers whole over the axis too, which the layers get whole.
        Raises where two such blocks coincide, or where "model" shares a
        dimension with another axis."""
        from ..tree import leaves
        table, rules = {}, None
        lays = leaves(layouts)
        for lay, keep in zip(lays, keeps or [(AXIS,)] * len(lays),
                             strict=True):
            rules = lay.rules
            axes, shape = _unstacked(lay.axes, lay.shape)
            spec = lay.spec[len(lay.axes) - len(axes):]
            dims = [d for d, e in enumerate(spec)
                    if AXIS in shd._entries(e)]
            if dims and spec[dims[0]] != AXIS:
                raise ValueError(f"leaf {lay.axes}: {AXIS!r} shares a "
                                 f"dimension ({spec})")
            table[axes, shape] = dims[0] if dims and AXIS in keep else None
        size = comm.axis_sizes(mesh)[AXIS]
        blocks = {}
        for (axes, shape), dim in table.items():
            key = (axes, _block(shape, dim, size))
            if blocks.setdefault(key, (shape, dim)) != (shape, dim):
                raise ValueError(f"leaves with axes {axes} differ: "
                                 f"{blocks[key]} and {(shape, dim)} have "
                                 f"the same block {key[1]}")
        return cls(mesh, AXIS, comm.coordinate(mesh, AXIS), size,
                   tuple((a, s, d) for (a, s), d in table.items()), rules)

    def for_stream(self, shape: Sequence[int]) -> "TensorParallel":
        """This context for a call whose residual stream is ``shape`` (B,
        S, D): ``seq`` set where the rules' spec of :data:`STREAM_AXES`
        puts the axis on S, unset where it does not divide S or the rules
        map "seq" to no axis.  B may be a device's rows: the axis is not a
        batch axis where this context exists (:func:`applies`)."""
        spec = self.rules.spec(STREAM_AXES, tuple(shape), self.mesh)
        return dataclasses.replace(
            self, seq=self.axis in shd._entries(spec[1]))

    def own_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This device's rows (dimension 1) of a whole stream ``x``."""
        n = _rows(x, self)
        return x.narrow(1, self.index * n, n)

    def dim_of(self, axes: Sequence[Optional[str]]) -> Optional[int]:
        """The dimension the axis splits in leaves with logical ``axes``;
        None where they stay whole.  Raises where leaves with these axes
        split differently (ask :meth:`split_dim` with the leaf)."""
        dims = {d for _, d in self._entries(axes)}
        if len(dims) > 1:
            raise ValueError(f"leaves with axes {tuple(axes)} split "
                             f"differently: {dims}")
        return dims.pop()

    def split_dim(self, w: torch.Tensor, axes: Sequence[Optional[str]]
                  ) -> Optional[int]:
        """The dimension the axis splits in the leaf ``w`` of logical
        ``axes`` (None: whole), which must be this device's block of one
        of the leaves with these axes (a split leaf that came whole
        raises)."""
        blocks = {_block(shape, dim, self.size): dim
                  for shape, dim in self._entries(axes)}
        if tuple(w.shape) not in blocks:
            want = " or ".join(str(b) for b in blocks)
            raise ValueError(f"leaf {tuple(axes)} has shape "
                             f"{tuple(w.shape)}, its block is {want}")
        return blocks[tuple(w.shape)]

    def _entries(self, axes):
        """(whole shape, split dimension) of every leaf with ``axes``."""
        got = [(shape, dim) for a, shape, dim in self.leaves
               if a == tuple(axes)]
        if not got:
            raise KeyError(f"no leaf with axes {tuple(axes)}")
        return got

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
    a mesh and where the step gathers each layer whole."""
    return _active


def seq_split() -> Optional[TensorParallel]:
    """The active context where this call's residual stream is split by
    rows over the axis, else None: the one question the layer code asks
    of the stream (its rows: :meth:`TensorParallel.own_rows`)."""
    return _active if _active is not None and _active.seq else None


@contextlib.contextmanager
def whole_stream():
    """The active context with the stream whole, for a span that computes
    on rows every device of the axis holds (the prefill's last row)."""
    with use(_active and dataclasses.replace(_active, seq=False)):
        yield


def _block(shape: Tuple[int, ...], dim: Optional[int], size: int
           ) -> Tuple[int, ...]:
    """A device's block of a leaf of whole ``shape`` split at ``dim``
    (None: whole) over ``size`` devices."""
    if dim is None:
        return tuple(shape)
    return shape[:dim] + (shape[dim] // size,) + shape[dim + 1:]


def _rows(x: torch.Tensor, tp: TensorParallel) -> int:
    """The rows a device holds of ``x``'s dimension 1 split over the
    axis; raises where they do not divide."""
    if x.shape[1] % tp.size:
        raise ValueError(f"a stream of {x.shape[1]} rows over {tp.size} "
                         f"devices")
    return x.shape[1] // tp.size


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


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, copies):
        ctx.tp, ctx.copies = tp, copies
        return comm.all_gather(x, tp.mesh, tp.axis, 1)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        if ctx.copies:
            return tp.own_rows(g), None, None
        _rows(g, tp)
        return comm.reduce_scatter(g, tp.mesh, tp.axis, 1), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        _rows(x, tp)
        return comm.reduce_scatter(x, tp.mesh, tp.axis, 1)

    @staticmethod
    def backward(ctx, g):
        return comm.all_gather(g, ctx.tp.mesh, ctx.tp.axis, 1), None


def gather_seq(x: torch.Tensor, tp: TensorParallel, copies: bool = False
               ) -> torch.Tensor:
    """The whole stream (B, S, ...) from every device's rows of it; the
    gradient reduce-scattered back to the rows.  With ``copies`` what
    follows is the same whole computation on every device of the axis
    (the unembedding of a vocab it does not split): the gradient is the
    same on each, and this device takes its rows of it, unsummed."""
    return _GatherSeq.apply(x, tp, copies)


def scatter_seq(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """This device's rows of ``x`` (B, S, ...) summed over the axis (a
    row split's partial sums); the gradient all-gathered back."""
    return _ScatterSeq.apply(x, tp)


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp.own_rows(x).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return comm.all_gather(g, ctx.tp.mesh, ctx.tp.axis, 1), None


def split_seq(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """This device's rows of ``x`` (B, S, ...), which every device of the
    axis holds whole; the gradient all-gathered back to the whole."""
    return _SplitSeq.apply(x, tp)


def last_row(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The last row (B, 1, ...) of a stream split by rows, on every device
    of the axis: the axis's last device's, broadcast (no gradient)."""
    return comm.broadcast(x[:, -1:].clone(memory_format=
                                          torch.contiguous_format),
                          tp.mesh, tp.axis, tp.size - 1)


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
    return comm.all_gather(logits, tp.mesh, tp.axis, logits.dim() - 1)


def applies(cfg, mesh, rules: shd.AxisRules, rows: Optional[int]) -> bool:
    """Whether a mesh step of ``cfg`` splits its layers over "model": the
    dense, VLM, MoE and hybrid decoders with GQA or MLA attention and the
    encoder-decoder (a MoE model where its routed experts and its shared
    experts' width divide the axis, so each device holds a block of the
    experts; a hybrid where its Mamba2 heads do, so each device holds
    whole heads; an encoder-decoder where its heads do, as its
    cross-attention needs), on a mesh with a "model" axis of more than
    one device that the batch of ``rows`` rows (the rules' "batch" entry
    where not given) is not cut over."""
    if cfg.family not in ("dense", "vlm", "moe", "hybrid", "encdec") \
            or cfg.attn not in ("gqa", "mla") \
            or mesh is None or AXIS not in mesh.mesh_dim_names:
        return False
    size = comm.axis_sizes(mesh)[AXIS]
    if size == 1 or cfg.family == "moe" and (
            cfg.n_experts % size or cfg.n_shared * cfg.d_ff_expert % size):
        return False
    if cfg.family == "hybrid" and (
            cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim) % size:
        return False
    if cfg.family == "encdec" and cfg.n_heads % size:
        return False
    batch = rules.get("batch") if rows is None \
        else rules.spec(("batch",), (rows,), mesh)[0]
    return AXIS not in shd._entries(batch)


def keeps(layouts) -> list:
    """The ``keep`` of each parameter leaf (flatten order) in a step of
    context ``tp`` (``sharding.for_layers``): ``("model",)``, so the layers
    get each leaf's "model" block, but ``()`` for the leaves named in
    :data:`WHOLE_OVER_MODEL`, which they get whole."""
    def walk(t, name):
        if isinstance(t, dict):
            return [k for key in sorted(t) for k in walk(t[key], key)]
        return [() if name in WHOLE_OVER_MODEL else (AXIS,)]
    return walk(layouts, None)
