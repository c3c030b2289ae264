"""Foundation of the port's model zoo, after ``repro/models/common.py``.

Parameters are plain nested dicts of tensors with the JAX package's names
and layouts, so a JAX parameter tree converts key for key
(``repro_torch.convert``).  Every model defines a *spec tree* of
:class:`ParamSpec` leaves (shape, dtype, logical axes, init), from which
:func:`init_params` makes random weights on a device.

The model's pieces take two routes.  By default (the serving route) each
norm, MoE expert product, SSD and sLSTM recurrence goes through its
``ops`` wrapper: the kernel on the card, its plain version on the CPU.
With ``plain=True`` (the plain route, which ``transformer.lm_loss``
takes) they run in plain PyTorch on any device and are differentiable,
as the JAX package's training forward computes them in plain jnp; the
kernels have no backward.  Attention follows ``cfg.attn_impl`` on both
routes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops, ref
from ..parallel import tensor
from ..tree import tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Shape + dtype + logical axes of one parameter tensor."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"     # "normal" | "zeros" | "ones" | "embed"
    scale: Optional[float] = None  # override fan-in scale

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def spec_map(fn: Callable[[ParamSpec], Any], tree: PyTree) -> PyTree:
    if isinstance(tree, ParamSpec):
        return fn(tree)
    return {k: spec_map(fn, v) for k, v in tree.items()}


def spec_leaves(tree: PyTree):
    if isinstance(tree, ParamSpec):
        yield tree
    else:
        for k in sorted(tree):
            yield from spec_leaves(tree[k])


def count_params(spec_tree: PyTree) -> int:
    return sum(math.prod(s.shape) for s in spec_leaves(spec_tree))


def _fan_in(shape: Tuple[int, ...]) -> int:
    # Last axis is the output axis by convention; everything else is fan-in.
    if len(shape) <= 1:
        return max(shape[0] if shape else 1, 1)
    return max(math.prod(shape[:-1]), 1)


def init_params(spec_tree: PyTree, generator: Optional[torch.Generator],
                device) -> PyTree:
    """Materialise a spec tree on ``device``: truncated normal in [-2, 2]
    times the fan-in scale (0.02 for embeddings), zeros, or ones.

    ``generator`` must live on ``device``; the draws differ from the JAX
    package's (another generator), so tests convert JAX's weights instead.
    """
    def one(s: ParamSpec):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        scale = s.scale
        if scale is None:
            scale = 1.0 if s.init == "embed" else 1.0 / math.sqrt(
                _fan_in(s.shape))
        w = torch.empty(s.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return w.mul_(scale).to(s.dtype)
    return spec_map(one, spec_tree)


def abstract_params(spec_tree: PyTree, placement_fn=None,
                    device="meta") -> PyTree:
    """Tensors without storage for a spec tree, where JAX's package has
    ``ShapeDtypeStruct`` leaves with a ``NamedSharding``.

    ``placement_fn(axes, shape)`` gives a leaf's per-device shard shape
    (the whole shape without one).  Leaves are meta tensors, or the fake
    tensors of an active ``FakeTensorMode`` on ``device``.
    """
    def one(s: ParamSpec):
        shape = s.shape if placement_fn is None \
            else tuple(placement_fn(s.axes, s.shape))
        return torch.empty(shape, dtype=s.dtype, device=device)
    return tree_map(one, spec_tree)


def param_axes(spec_tree: PyTree) -> PyTree:
    """The logical axes of every leaf (a tuple a leaf), in the spec tree's
    nest; a dict of specs gives a dict of tuples, as JAX's does."""
    return spec_map(lambda s: s.axes, spec_tree)


# ---------------------------------------------------------------------------
# Common neural pieces (functions over param dicts)
# ---------------------------------------------------------------------------


def rmsnorm_spec(dim: int) -> Dict[str, ParamSpec]:
    return {"scale": ParamSpec((dim,), ("embed",), init="ones")}


def rmsnorm(params, x, eps: float = 1e-5, *, plain: bool = False):
    """fp32-math RMSNorm: through the RMSNorm kernel (plain on the CPU), or
    in plain PyTorch on the plain route.  On a stream split by rows
    (``tensor.seq_split``) the whole scale's gradient from this device's
    rows is summed over the axis."""
    scale, sp = params["scale"], tensor.seq_split()
    if sp is not None:
        scale = tensor.into_split(scale, sp)
    if plain:
        return ref.rmsnorm_ref(x, scale, eps)
    return ops.fused_rmsnorm(x, scale, eps=eps)


EMBED_AXES = ("vocab", "embed")


def embed_spec(vocab: int, dim: int) -> Dict[str, ParamSpec]:
    return {"embedding": ParamSpec((vocab, dim), EMBED_AXES,
                                   init="embed", scale=0.02)}


def vocab_split(params) -> Optional[tensor.TensorParallel]:
    """The tensor-parallel context where the embedding is this device's
    vocab block (``parallel.tensor``), else None."""
    tp = tensor.active()
    if tp is None or tp.split_dim(params["embedding"], EMBED_AXES) is None:
        return None
    return tp


def vocab_start(params) -> int:
    """The first vocab row of the embedding this device holds."""
    tp = vocab_split(params)
    return 0 if tp is None else tp.index * params["embedding"].shape[0]


def _after(before, x):
    """``x``'s rows after ``before``'s (dimension 1), in ``before``'s
    dtype; ``x`` where there is nothing before."""
    return x if before is None else torch.cat([before, x.to(before.dtype)],
                                              dim=1)


def embed(params, tokens, before=None):
    """The tokens' rows, after the rows of ``before`` (B, P, D; a VLM's
    image patches) where given; from a vocab block, the rows it holds
    (zeros for the others) summed over the blocks.  On a stream split by
    rows (``tensor.seq_split``) this device's rows of that sequence: a
    vocab block's partial rows reduce-scattered (``before`` entering the
    sum from the axis's first device only), or cut from the whole
    sequence of a whole table (``tensor.split_seq``)."""
    table = params["embedding"]
    tp, sp = vocab_split(params), tensor.seq_split()
    if tp is None:
        x = _after(before, table[tokens])
        return x if sp is None else tensor.split_seq(x, sp)
    local = tokens - vocab_start(params)
    own = (local >= 0) & (local < table.shape[0])
    rows = torch.where(own[..., None], table[torch.where(own, local, 0)], 0)
    if sp is None:
        return _after(before, tensor.out_of_split(rows, tp))
    if before is not None and sp.index:
        before = torch.zeros_like(before)
    return tensor.scatter_seq(_after(before, rows), sp)


def unembed(params, x):
    """Logits via the tied output table: (..., D) -> (..., V), or this
    device's vocab block of them (..., V/m) from a vocab block.  From a
    stream split by rows, the logits of the whole sequence (the rows
    gathered)."""
    tp, sp = vocab_split(params), tensor.seq_split()
    if sp is not None:
        x = tensor.gather_seq(x, sp, copies=tp is None)
    elif tp is not None:
        x = tensor.into_split(x, tp)
    return x @ params["embedding"].T


def whole_vocab(params, logits):
    """The logits over the whole vocab: a vocab block's gathered."""
    tp = vocab_split(params)
    return logits if tp is None else tensor.gather_vocab(logits, tp)


def dense_spec(d_in: int, d_out: int,
               axes: Tuple[Optional[str], Optional[str]],
               init: str = "normal") -> ParamSpec:
    return ParamSpec((d_in, d_out), axes, init=init)


MLP_IN, MLP_OUT = ("embed", "mlp"), ("mlp", "embed")


def swiglu_spec(d_model: int, d_ff: int) -> Dict[str, ParamSpec]:
    return {
        "w_gate": dense_spec(d_model, d_ff, MLP_IN),
        "w_up": dense_spec(d_model, d_ff, MLP_IN),
        "w_down": dense_spec(d_ff, d_model, MLP_OUT),
    }


def swiglu_sum(params, x):
    """The SwiGLU's products, with no collective: from blocks of the
    hidden width, this block's share of the sum over the blocks."""
    return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) \
        @ params["w_down"]


def swiglu(params, x):
    """SwiGLU; from blocks of the hidden width (``parallel.tensor``), gate
    and up split by columns and down by rows, summed over the blocks.  On
    a stream split by rows (``tensor.seq_split``) the blocks take the
    gathered rows and the sums go back reduce-scattered; whole weights
    compute the whole sequence on every device, which keeps its rows."""
    tp, sp = tensor.active(), tensor.seq_split()
    if tp is not None and tp.split_dim(params["w_gate"], MLP_IN) is None:
        tp = None
    if tp is not None:
        tp.split_dim(params["w_up"], MLP_IN)
        tp.split_dim(params["w_down"], MLP_OUT)
        x = tensor.into_split(x, tp) if sp is None \
            else tensor.gather_seq(x, sp)
    elif sp is not None:
        x = tensor.gather_seq(x, sp, copies=True)
    y = swiglu_sum(params, x)
    if sp is None:
        return y if tp is None else tensor.out_of_split(y, tp)
    return tensor.split_seq(y, sp) if tp is None \
        else tensor.scatter_seq(y, sp)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, Dh) or (..., S, Dh); positions: (..., S).

    Split-halves rotation (first half with the second), as
    ``repro/models/common.py::apply_rope``.
    """
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)
    ang = positions[..., None].float() * freqs
    if x.dim() == ang.dim() + 1:                       # has a heads axis
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mask_padded_vocab(logits, vocab: int, start: int = 0):
    """-1e30 on the padded tail of the vocab axis; ``logits`` are the
    vocab rows from ``start`` on (a vocab block's)."""
    n = logits.shape[-1]
    if start + n <= vocab:
        return logits
    valid = start + torch.arange(n, device=logits.device) < vocab
    return logits.masked_fill(~valid, -1e30)


def cross_entropy(logits, labels, mask=None, *, split=None):
    """Mean token-level CE in fp32; labels < 0 are ignored.

    One ``F.cross_entropy`` sum over the valid tokens divided by their
    count: its backward writes each row's gradient once, so it is the same
    bits every run on the card (a gather's backward would scatter-add).
    With ``split`` (a ``parallel.tensor`` context) the logits are this
    device's vocab block, and the loss is ``tensor.vocab_cross_entropy``.
    """
    if split is not None:
        if mask is not None:
            labels = torch.where(mask, labels, -1)
        return tensor.vocab_cross_entropy(logits, labels, split)
    logits = logits.float()
    valid = labels >= 0 if mask is None else mask & (labels >= 0)
    target = torch.where(valid, labels, -100).long()
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          target.reshape(-1), ignore_index=-100,
                          reduction="sum")
    return nll / torch.clamp(valid.sum(), min=1)
