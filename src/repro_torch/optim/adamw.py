"""AdamW with fp32 master weights over parameter trees, after
``repro/optim/adamw.py``.

The arithmetic is the JAX package's, op for op.  The state is updated in
place (the JAX trainer donates it): ``adamw_update`` writes the new
moments and masters into the tensors of the state it is given, and the
new params into ``out`` when the caller passes the old ones, so a step
needs no second copy of the state.  A leaf is updated in pieces of at
most ``PIECE`` elements, which bounds the update's temporaries: full-width
glm4_9b's embedding is one leaf of 621 M entries, 2.5 GB in fp32.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from ..models.common import ParamSpec, spec_map
from ..tree import leaves, tree_map, unflatten

PIECE = 1 << 26         # elements of a leaf updated at a time (256 MB fp32)


class OptState(NamedTuple):
    step: Any          # () int32
    master: Any        # fp32 copy of params (same tree)
    m: Any             # first moment (fp32)
    v: Any             # second moment (fp32)


def adamw_init(params) -> OptState:
    """Zero moments and fp32 masters that are fresh copies of ``params``,
    never aliases of them."""
    first = leaves(params)[0]
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        master=tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                        params),
        m=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params),
        v=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params))


def adamw_init_spec(spec_tree) -> OptState:
    """Spec-tree version (no allocation)."""
    f32spec = spec_map(
        lambda s: ParamSpec(s.shape, s.axes, torch.float32, init="zeros"),
        spec_tree)
    return OptState(
        step=ParamSpec((), (), torch.int32, init="zeros"),
        master=spec_map(lambda s: ParamSpec(s.shape, s.axes, torch.float32,
                                            init=s.init, scale=s.scale),
                        spec_tree),
        m=f32spec, v=f32spec)


def _pieces(*tensors):
    """Matching flat views of ``tensors``, ``PIECE`` elements at a time; an
    in-place op on a piece writes its tensor."""
    flat = [t.view(-1) for t in tensors]
    for i in range(0, flat[0].numel(), PIECE):
        yield [f[i:i + PIECE] for f in flat]


def global_norm(grads):
    """sqrt of the sum over leaves of each leaf's sum of squares, fp32."""
    return torch.sqrt(sum(
        sum(torch.sum(torch.square(g.float())) for (g,) in _pieces(leaf))
        for leaf in leaves(grads)))


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def adamw_update(grads, state: OptState, lr, *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_norm: float = 1.0,
                 param_dtype=torch.bfloat16,
                 out=None, gnorm=None) -> Tuple[Any, OptState]:
    """One AdamW step. Returns (new params in ``param_dtype``, new state).

    Global-norm clipping is a scalar scale fused into the moment update,
    not a clipped copy of the gradient tree.  ``lr`` is a float or a 0-d
    tensor.  ``state``'s master, m and v are updated in place and the new
    state holds the same tensors; with ``out`` (a params tree) the new
    params are written into its tensors and it is returned, else they are
    new tensors.  ``gnorm``, when given, is the global norm to clip by (a
    sharded step's, summed over the mesh), else that of ``grads``.
    """
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    b1c = 1.0 - b1 ** step.float()
    b2c = 1.0 - b2 ** step.float()
    flat_g = leaves(grads)
    flat_m, flat_v = leaves(state.m), leaves(state.v)
    flat_p = leaves(state.master)
    for leaf in zip(flat_g, flat_m, flat_v, flat_p, strict=True):
        for g, m, v, p in _pieces(*leaf):
            g = g.float() * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square_())
            mh = m / b1c
            mh.div_((v / b2c).sqrt_().add_(eps))
            p.sub_(mh.add_(weight_decay * p).mul_(lr))
    if out is None:
        new_params = unflatten(grads, [p.to(param_dtype, copy=True)
                                       for p in flat_p])
    else:
        for o, p in zip(leaves(out), flat_p, strict=True):
            o.copy_(p)
        new_params = out
    return new_params, OptState(step=step, master=state.master, m=state.m,
                                v=state.v)
