"""Fine-grained Mixture-of-Experts (DeepSeekMoE-style), after
``repro/models/moe.py``.

Shared experts (always-on dense SwiGLU) + routed experts with top-k
softmax routing, with the JAX package's sort-based capacity dispatch:

  1. flatten tokens, top-k expert ids per token;
  2. stable-sort the (token, expert) pairs by expert id;
  3. position-in-expert = rank within the sorted run; slots >= capacity drop;
  4. gather into an (E, C, D) buffer (each slot's token, one gather, so
     no (N*k, D) copy of the tokens is made), batched expert SwiGLU whose three
     products go through the grouped-matmul kernel (``ops.moe_gmm``, given
     each expert's row count, so experts without rows read no weights),
     or, on the plain route (``plain=True``, the training forward), are
     the JAX package's einsums; scatter back, weighted combine.

Inside a mesh step (``parallel.sharding.row_groups()``) the dispatch is
the one GSPMD gives JAX's code over the global batch: the capacity counts
every row group's tokens, and a slot's position in its expert is its
local one plus that expert's slots in the lower row groups (an all-gather
of the E counts), which is JAX's stable sort of the global batch, since
tokens are flattened b-major and a group's rows are contiguous.  The
expert buffer stays sized by the local tokens; a slot drops by its global
position.

Under expert parallelism (a tensor-parallel mesh step, ``parallel.tensor``,
whose rules put "experts" on "model", as JAX's do) each device of the
axis holds a block of E/m experts, ``w_gate`` / ``w_up`` (E/m, D, F) and
``w_down`` (E/m, F, D), the router whole.  The tokens enter once, whole
on every device (``tensor.gather_seq`` from a stream split by rows, else
``tensor.into_split``); every device routes all of them (the same ids,
counts, capacity and positions), builds the buffer of its own experts
only, and combines its slots with the shared experts' block of the hidden
width into a partial (N, D), which leaves through one
``tensor.scatter_seq`` (or ``tensor.out_of_split``).  The router enters
through ``tensor.into_split``: each device's gradient of it is a partial
sum.

On the card ``moe_apply`` never waits for the host: the capacity comes
from shapes, the counts per expert from ``scatter_add_`` (and stay on the
device through the all-gather), and every index is a device tensor (no
boolean-mask indexing, no ``bincount``, no ``.item()``).  ``moe_ref``
(dense every-expert evaluation) is the oracle for tests; with a generous
capacity factor the two agree.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..parallel import tensor
from ..parallel.sharding import row_groups
from .common import MLP_IN, ParamSpec, swiglu, swiglu_spec, swiglu_sum

EXPERT_AXES = ("experts", "embed", "mlp")          # w_gate, w_up
EXPERT_DOWN_AXES = ("experts", "mlp", "embed")     # w_down


def moe_spec(d_model: int, n_experts: int, d_ff_expert: int,
             n_shared: int) -> Dict:
    sp = {
        "router": ParamSpec((d_model, n_experts), ("embed", None),
                            scale=0.02),
        "w_gate": ParamSpec((n_experts, d_model, d_ff_expert),
                            EXPERT_AXES),
        "w_up": ParamSpec((n_experts, d_model, d_ff_expert), EXPERT_AXES),
        "w_down": ParamSpec((n_experts, d_ff_expert, d_model),
                            EXPERT_DOWN_AXES),
    }
    if n_shared > 0:
        sp["shared"] = swiglu_spec(d_model, d_ff_expert * n_shared)
    return sp


def route(params, x_flat, top_k: int):
    """Router probs -> (weights, ids, probs), weights renormalised over
    the top-k.  The router runs in fp32."""
    logits = x_flat.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, top_k, dim=-1)          # (N,k)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    return weights, ids, probs


def aux_load_balance_loss(probs, ids, n_experts: int):
    """Switch-style load-balance loss: E * sum_e f_e * p_e."""
    flat = ids.reshape(-1)
    counts = torch.zeros(n_experts, dtype=torch.float32, device=probs.device)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    frac = counts / max(ids.numel(), 1)
    return n_experts * torch.sum(frac * probs.mean(dim=0))


def expert_split(params) -> Optional[tensor.TensorParallel]:
    """The tensor-parallel context, where the routed experts are this
    device's block of them and the shared experts its block of their
    hidden width (expert parallelism over "model"); None off a mesh step
    or in one that gathers each layer whole.  Either left whole in a
    tensor-parallel step raises: ``tensor.applies`` admits a MoE model
    only where both divide the axis."""
    tp = tensor.active()
    if tp is not None and (
            tp.split_dim(params["w_gate"], EXPERT_AXES) != 0
            or "shared" in params
            and tp.split_dim(params["shared"]["w_gate"], MLP_IN) is None):
        raise NotImplementedError("MoE weights whole in a tensor-parallel "
                                  "step")
    return tp


def moe_apply(params, x, top_k: int, capacity_factor: float = 1.25,
              return_aux: bool = False, *, plain: bool = False):
    """x: (B,S,D) -> (B,S,D).  Sort-based dispatch, see module docstring."""
    tp = expert_split(params)
    router = params["router"]
    if tp is not None:
        if return_aux:      # its gradient would be summed over the axis
            raise NotImplementedError("the aux loss under expert "
                                      "parallelism")
        # the tokens once, whole on every device of the axis; their
        # gradient, and the router's, summed over it
        sp = tensor.seq_split()
        x = tensor.into_split(x, tp) if sp is None \
            else tensor.gather_seq(x, sp)
        router = tensor.into_split(router, tp)
    b, s, d = x.shape
    e = router.shape[1]
    el = params["w_gate"].shape[0]                 # this device's experts
    e0 = 0 if tp is None else tp.index * el
    n = b * s
    dev = x.device
    xf = x.reshape(n, d)
    weights, ids, probs = route({"router": router}, xf, top_k)

    nk = n * top_k
    groups = row_groups()
    n_all = n if groups is None else n * groups.count
    cap = int(max(1, (n_all * top_k / e) * capacity_factor))
    flat_ids = ids.reshape(nk)
    flat_w = weights.reshape(nk)
    tok = torch.arange(nk, device=dev) // top_k            # token of a pair

    order = torch.argsort(flat_ids, stable=True)
    s_ids = flat_ids[order]
    s_tok = tok[order]
    s_w = flat_w[order]
    counts = torch.zeros(e, dtype=torch.long, device=dev).scatter_add_(
        0, flat_ids, torch.ones_like(flat_ids))
    starts = torch.cumsum(counts, 0) - counts              # exclusive prefix
    pos = torch.arange(nk, device=dev) - starts[s_ids]
    if groups is None:
        width = cap
        keep = pos < cap
        rows = counts.clamp_max(cap)
    else:
        # the expert's slots in the lower row groups come first in JAX's
        # global sort; local positions past nk never occur
        below = groups.below(counts.to(torch.int32))
        width = min(cap, nk)
        keep = pos + below[s_ids] < cap
        rows = torch.minimum(counts, (cap - below).clamp_min(0))
    # The rows each local expert holds, on the device: its kept slots are
    # its first positions.
    rows = rows[e0:e0 + el].to(torch.int32)
    # JAX writes with mode="drop" and reads with mode="fill": here a pair
    # that is dropped, or whose expert another device holds, goes to a
    # sink past the (el * width) slots of this device's buffer, and its
    # combine weight is 0.
    if tp is None:
        mine, local = keep, s_ids
    else:
        mine, local = keep & (s_ids >= e0) & (s_ids < e0 + el), s_ids - e0
    slot = torch.where(mine, pos.add(local, alpha=width), el * width)
    # The buffer from each slot's token, one gather.  A slot past its
    # expert's rows holds token 0's row where JAX's buffer holds zeros: no
    # pair combines its output (a dropped pair reads a slot with weight
    # 0), so it adds exact zeros forward and backward.
    src = torch.zeros(el * width + 1, dtype=torch.long, device=dev
                      ).scatter_(0, slot, s_tok)[:-1]
    slots = xf.index_select(0, src).view(el, width, d)

    if plain:
        g = torch.einsum("ecd,edf->ecf", slots, params["w_gate"])
        u = torch.einsum("ecd,edf->ecf", slots, params["w_up"])
        out_buf = torch.einsum("ecf,efd->ecd", F.silu(g) * u,
                               params["w_down"])
    else:
        # The kernel skips experts without rows and writes exact zeros
        # past each count, so the down product's input there is
        # silu(0) * 0 = 0.
        g = ops.moe_gmm(slots, params["w_gate"], rows)
        u = ops.moe_gmm(slots, params["w_up"], rows)
        out_buf = ops.moe_gmm(F.silu(g) * u, params["w_down"], rows)

    # Weighted combine, added straight into the (N, D) output: this
    # device's slots, a partial sum over the axis under expert parallelism.
    slot_out = out_buf.reshape(el * width, d).index_select(
        0, slot.clamp_max(el * width - 1))
    s_w = torch.where(mine, s_w, 0.0).to(x.dtype)
    y = torch.zeros((n, d), dtype=x.dtype, device=dev).index_add_(
        0, s_tok, slot_out * s_w[:, None])

    if "shared" in params:
        # under expert parallelism the shared experts' block of the hidden
        # width, on the tokens already gathered: a partial sum too
        y = y + (swiglu(params["shared"], xf) if tp is None
                 else swiglu_sum(params["shared"], xf))
    y = y.reshape(b, s, d)
    if tp is not None:
        return tensor.out_of_split(y, tp) if sp is None \
            else tensor.scatter_seq(y, sp)
    if return_aux:
        return y, aux_load_balance_loss(probs, ids, e)
    return y


def moe_ref(params, x, top_k: int):
    """Oracle: evaluate EVERY expert for every token, dense mixture."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    weights, ids, _ = route(params, xf, top_k)
    g = torch.einsum("nd,edf->nef", xf, params["w_gate"])
    u = torch.einsum("nd,edf->nef", xf, params["w_up"])
    h = F.silu(g) * u
    all_out = torch.einsum("nef,efd->ned", h, params["w_down"])  # (N,E,D)
    sel = torch.take_along_dim(all_out, ids[..., None], dim=1)  # (N,k,D)
    y = (sel * weights[..., None]).sum(dim=1).to(x.dtype)
    if "shared" in params:
        y = y + swiglu(params["shared"], xf)
    return y.reshape(b, s, d)
