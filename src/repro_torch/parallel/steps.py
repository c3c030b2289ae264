"""Step functions (train / eval / prefill / serve) of the port, after
``repro/parallel/steps.py``, on one device or on a mesh.

On one device: the training state, its spec, its initialisation, the
train step (value and grad, microbatch accumulation, error-feedback
gradient compression, warmup-cosine lr, AdamW), the eval, prefill and
serve steps.

On a mesh (``mesh=``, ``rules=``; ``sharding``'s layouts) each device
holds the block of every state leaf that JAX's ``NamedSharding`` gives
it, and a step is data parallel with FSDP state, gathered one layer at a
time as GSPMD runs JAX's scanned layers: the step hands the model its
blocks (``sharding.for_layers``), each stacked leaf as a
``sharding.Stacked`` of its layers' blocks and every other leaf (the
embedding, the final norm, Whisper's) gathered at the top; each layer's
body gathers its own weights (``sharding.layer``), inside what remat
checkpoints, so they are freed after the layer and gathered again in its
recompute.  A stacked leaf never reaches the layers whole: in a mesh
step (``sharding.use_blocks``, a module global, since on the card
autograd runs the remat recompute on its own thread) a plain tensor
there raises.  Each layer's block is its own autograd input, and the
gather's backward reduces that layer's gradient into the block
(reduce-scatter, then all-reduce over the axes that replicate the leaf),
so every gradient leaves the backward in the parameters' layout; the
microbatches' block gradients are summed in an fp32 accumulator of
blocks, each dropped before the next microbatch runs, as JAX's
``shard_like_params(zeros)`` scan holds them.  The step runs the
one-device loss on this device's rows of the batch, weighs each
microbatch's loss by this device's share of the global count of valid
labels (so the sum over the mesh is JAX's one global mean, however the
masked labels fall) and updates its blocks with AdamW.  Prefill and
serve take the same blocks and gather each layer in its turn.  Inside
every mesh step of a MoE model the dispatch sees the step's row groups
(``sharding.row_groups``: the blocks of devices that the rules cut the
``global_batch=`` rows over) and takes JAX's global capacity and
positions.

The dense, VLM, MoE and hybrid decoders (GQA or MLA attention) and the
encoder-decoder compute tensor parallel over "model" where the rules do
not cut the batch over it (``act_shard="seq"``; ``parallel.tensor``): a
layer gathers each leaf over every other axis, the layers take each
leaf's "model" block (query heads, MLA's decompression, MLP columns and
rows, experts, vocab rows, Mamba2's heads) and sum their partial results
over the axis, the gradients stay those blocks (reduced over the other
axes only), and the label count and the reported loss sum over the
other axes only, since the devices of a model axis are parts of one
computation, not copies; the residual stream is split by rows over the
axis where the rules put "model" on its sequence (the encoder-decoder's
encoder and decoder streams each by its own length).  Mamba2's fused
in_proj and conv are gathered whole over "model" too (``tensor.keeps``),
and the layer slices its heads' columns.  Everywhere else (the xLSTM
family, ``act_shard="batch2d"``, a model axis of one device) each layer
is gathered whole.  The ``abstract_*`` helpers give a device's
arguments without storage, for the dry run.

The train step updates the state in place, as the JAX trainer donates it
(``donate_argnums=(0,)``), and returns it with its metrics as 0-d
tensors on the state's device, so a step waits for the card nowhere.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ArchConfig, InputShape
from ..models import api, attention
from ..models.transformer import init_cache
from ..models.common import ParamSpec, abstract_params, init_params, spec_map
from ..optim import (adamw_init, adamw_init_spec, adamw_update,
                     error_feedback_update, linear_warmup_cosine)
from ..tree import leaves, tree_map, unflatten
from . import comm
from . import sharding as shd
from . import tensor


class TrainState(NamedTuple):
    params: Any
    opt: Any
    ef_err: Any = None      # error-feedback residuals (compression on)


def train_state_spec(cfg: ArchConfig,
                     compress: bool = False) -> TrainState:
    pspec = api.param_spec(cfg)
    # params live in the compute dtype; masters/moments in fp32
    pspec_dt = spec_map(
        lambda s: ParamSpec(s.shape, s.axes, cfg.torch_dtype, init=s.init,
                            scale=s.scale), pspec)
    ef = spec_map(lambda s: ParamSpec(s.shape, s.axes, torch.float32,
                                      init="zeros"), pspec) if compress \
        else None
    return TrainState(params=pspec_dt, opt=adamw_init_spec(pspec),
                      ef_err=ef)


def init_train_state(cfg: ArchConfig, generator: torch.Generator, device,
                     compress: bool = False) -> TrainState:
    """Random fp32 weights from ``generator`` (on ``device``), params in
    ``cfg``'s dtype, fp32 masters copied from the weights, zero moments,
    and zero error-feedback residuals under ``compress``."""
    params32 = init_params(api.param_spec(cfg), generator, device)
    params = tree_map(lambda x: x.to(cfg.torch_dtype), params32)
    ef = tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                  params32) if compress else None
    return TrainState(params=params, opt=adamw_init(params32), ef_err=ef)


def loss_and_grads(loss_fn: Callable, params, batch):
    """(loss, gradient tree) of ``loss_fn(params, batch)`` at ``params``,
    the counterpart of ``jax.value_and_grad``: the leaves are detached
    views (no copy), and the gradients come back in a tree like
    ``params``."""
    live = [p.detach().requires_grad_() for p in leaves(params)]
    loss = loss_fn(unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), unflatten(params, list(grads))


def _block_grads(loss_fn: Callable, blocks, batch, layouts, keep=()):
    """:func:`loss_and_grads` of a mesh step at this device's ``blocks``
    (``sharding.for_layers``): each stacked leaf reaches the layers one
    layer at a time, each layer's block its own autograd input, gathered
    inside the layer's body; every other leaf is gathered at the top.
    Each gradient leaves the backward summed over the mesh and reduced
    into its block (``sharding.gather_leaf``), in a tree like
    ``blocks``."""
    live = []
    loss = loss_fn(shd.for_layers(blocks, layouts, keep, live), batch)
    flat = iter(torch.autograd.grad(loss, [t for ts in live for t in ts]))
    grads = []
    for x, lay, ts in zip(leaves(blocks), leaves(layouts), live,
                          strict=True):
        got = [next(flat) for _ in ts]
        grads.append(torch.stack(got).view(x.shape) if lay.stacked
                     else got[0])
    return loss.detach(), unflatten(blocks, grads)


def _accumulated(loss_fn: Callable, params, batch, accum: int,
                 weights: Optional[torch.Tensor] = None,
                 grads_of: Callable = loss_and_grads):
    """(loss, gradients) of one batch, or the means over its ``accum``
    microbatches (leading axis), accumulated in fp32 in order, each
    microbatch's gradients dropped once added.  ``grads_of(loss_fn,
    params, batch)`` gives a microbatch's (:func:`_block_grads` on a mesh,
    where ``params`` and the accumulator are this device's blocks).

    ``weights`` (``accum``,) scales each microbatch's loss before its
    backward: on a mesh, a device's share of that microbatch's global
    mean.  (Scaled there, each token's gradient seed is the global mean's
    to an ulp, as it would not be if the gradients were scaled after.)"""
    def weighted(i):
        if weights is None:
            return loss_fn
        return lambda p, b: loss_fn(p, b) * weights[i]
    if accum == 1:
        return grads_of(weighted(0), params, batch)
    grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    loss = 0.0
    for i in range(accum):
        l, g = grads_of(weighted(i), params,
                        {k: v[i] for k, v in batch.items()})
        torch._foreach_add_(leaves(grads), leaves(g))
        del g
        loss = loss + l
    torch._foreach_div_(leaves(grads), accum)
    return loss / accum, grads


def make_train_step(cfg: ArchConfig, *, base_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    accum: int = 1, compress_fraction: Optional[float] = None,
                    mesh=None, rules: Optional[shd.AxisRules] = None,
                    global_batch: Optional[int] = None) -> Callable:
    """(TrainState, batch) -> (TrainState, metrics).

    ``accum`` > 1 expects batch leaves with a leading microbatch axis and
    accumulates their gradients in fp32 in order, as JAX's ``lax.scan``
    does.  ``compress_fraction`` enables error-feedback top-k + int8
    gradient compression (``optim.compression``), on one device only.

    With ``mesh`` (and ``rules``, the default rules of ``cfg.act_shard``
    unless given) the state is this device's blocks (:func:`shard_state`)
    and the batch its rows (:func:`batch_rows`): see the module docstring.
    ``global_batch``, the rows of the whole batch before they are cut,
    is needed there for a MoE model (:func:`_row_groups`).
    """
    loss_fn = api.loss_fn(cfg)
    if mesh is not None:
        return _sharded_train_step(cfg, loss_fn, mesh, rules, base_lr,
                                   warmup, total_steps, accum,
                                   compress_fraction, global_batch)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        params = state.params
        loss, grads = _accumulated(loss_fn, params, batch, accum)

        new_ef = state.ef_err
        if compress_fraction is not None and state.ef_err is not None:
            pairs = [error_feedback_update(g.float(), e, compress_fraction)
                     for g, e in zip(leaves(grads), leaves(state.ef_err),
                                     strict=True)]
            grads = unflatten(grads, [p[0] for p in pairs])
            new_ef = unflatten(state.ef_err, [p[1] for p in pairs])

        lr = linear_warmup_cosine(state.opt.step, base_lr, warmup,
                                  total_steps)
        new_params, new_opt = adamw_update(grads, state.opt, lr,
                                           param_dtype=cfg.torch_dtype,
                                           out=params)
        metrics = {"loss": loss, "lr": lr, "step": new_opt.step}
        return TrainState(params=new_params, opt=new_opt,
                          ef_err=new_ef), metrics

    return step


def state_layouts(cfg: ArchConfig, mesh, rules: shd.AxisRules,
                  compress: bool = False) -> TrainState:
    """The :class:`sharding.Layout` of every leaf of the training state."""
    return shd.layouts(train_state_spec(cfg, compress), mesh, rules)


def shard_state(state, layouts):
    """This device's blocks of a whole state (a copy of each)."""
    return tree_map(lambda x, lay: lay.shard(x), state, layouts)


def gather_state(state, layouts):
    """The whole state from every device's blocks: new tensors, also where
    a leaf is whole or split over axes of one device only (there
    ``Layout.gather`` returns the block itself)."""
    def whole(x, lay):
        g = lay.gather(x)
        return g.clone() if g.data_ptr() == x.data_ptr() else g
    return tree_map(whole, state, layouts)


def _rules(cfg: ArchConfig, mesh, rules):
    if rules is not None:
        return rules
    return shd.default_rules(multi_pod="pod" in mesh.mesh_dim_names,
                             act_shard=cfg.act_shard)


def batch_rows(batch: Dict[str, Any], mesh, rules: shd.AxisRules,
               accum: int = 1) -> Dict[str, Any]:
    """This device's rows of a whole batch: each leaf's batch dimension
    (0, or 1 under ``accum``'s leading microbatch axis) cut as JAX's batch
    sharding cuts it; the devices off the batch axes hold the same rows."""
    lead = (None,) if accum > 1 else ()
    return {k: shd.shard_of(v, lead + ("batch",) + (None,) * (
        v.dim() - 1 - len(lead)), mesh, rules) for k, v in batch.items()}


def _row_groups(cfg: ArchConfig, mesh, rules: shd.AxisRules,
                global_batch: Optional[int],
                accum: int = 1) -> Optional[shd.RowGroups]:
    """The row groups that a MoE model's dispatch counts in a mesh step
    (``sharding.RowGroups``): those the rules cut a microbatch of
    ``global_batch // accum`` rows into, as :func:`batch_rows` cuts it.
    None for a model without MoE layers.  The rows must be given: the
    rules drop a batch axis that does not divide them, and a device sees
    only its own rows, so it cannot tell its group's rows from copies."""
    if cfg.family != "moe":
        return None
    if global_batch is None:
        raise ValueError(f"a mesh step of {cfg.name} (MoE) needs "
                         f"global_batch=: its dispatch takes the global "
                         f"batch's capacity")
    return shd.RowGroups.of(mesh, rules, global_batch // accum)


def _tensor_parallel(cfg, mesh, rules, lays, global_batch, accum: int = 1
                     ) -> Tuple[Optional[tensor.TensorParallel], Any]:
    """(the tensor-parallel context of a mesh step, ``parallel.tensor``,
    or None where the step gathers whole weights: off the dense, VLM, MoE
    and hybrid families with GQA or MLA attention and the encoder-decoder
    (``tensor.applies``), on a "model" axis of
    one device, and where the rules cut the batch (a microbatch of
    ``global_batch // accum`` rows, the rules' table where not given)
    over "model"; the ``keep`` of ``sharding.for_layers``: () without the
    context, else each leaf's, ``tensor.keeps``)."""
    rows = None if global_batch is None else global_batch // accum
    if not tensor.applies(cfg, mesh, rules, rows):
        return None, ()
    keep = tensor.keeps(lays)
    return tensor.TensorParallel.of(mesh, lays, keep), keep


def _stream_shape(cfg: ArchConfig, batch) -> Tuple[int, int, int]:
    """(B, S, D) of the residual stream of a batch (a microbatch's, under
    a leading microbatch axis): its tokens after a VLM's image patches."""
    b, s = batch["tokens"].shape[-2:]
    if "img_embeds" in batch:
        s += batch["img_embeds"].shape[-2]
    return b, s, cfg.d_model


def _for_batch(tp: Optional[tensor.TensorParallel], cfg, batch
               ) -> Optional[tensor.TensorParallel]:
    """The context of one call of a step: ``tp`` with its stream split
    where the rules split a stream of this batch's shape; ``tp`` as it is
    for the encoder-decoder, whose encoder and decoder streams each
    decide (``models.encdec``)."""
    if tp is None or cfg.family == "encdec":
        return tp
    return tp.for_stream(_stream_shape(cfg, batch))


def _sharded_train_step(cfg, loss_fn, mesh, rules, base_lr, warmup,
                        total_steps, accum, compress_fraction, global_batch):
    if compress_fraction is not None:
        raise ValueError("gradient compression on a mesh is not ported "
                         "(ROADMAP.md)")
    rules = _rules(cfg, mesh, rules)
    lays = state_layouts(cfg, mesh, rules).params
    groups = _row_groups(cfg, mesh, rules, global_batch, accum)
    tp, keep = _tensor_parallel(cfg, mesh, rules, lays, global_batch, accum)
    # the axes whose devices hold copies or other rows (those of "model"
    # under tensor parallelism are parts of one computation)
    axes = tuple(a for a in mesh.mesh_dim_names
                 if tp is None or a != tp.axis)

    def grads_of(fn, blocks, batch):
        return _block_grads(fn, blocks, batch, lays, keep)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        weights = _label_weights(batch["labels"], accum, mesh, axes)
        with shd.use_row_groups(groups), shd.use_blocks(), \
                tensor.use(_for_batch(tp, cfg, batch)):
            loss, grads = _accumulated(loss_fn, state.params, batch, accum,
                                       weights, grads_of)
        # the clipping norm: each block's squares once over the mesh
        sq = sum(g.float().square().sum() / lay.copies
                 for g, lay in zip(leaves(grads), leaves(lays), strict=True))
        gnorm = comm.all_reduce(sq.reshape(1), mesh,
                                mesh.mesh_dim_names)[0].sqrt()
        loss = comm.all_reduce(loss.reshape(1), mesh, axes)[0]
        lr = linear_warmup_cosine(state.opt.step, base_lr, warmup,
                                  total_steps)
        new_params, new_opt = adamw_update(grads, state.opt, lr,
                                           param_dtype=cfg.torch_dtype,
                                           out=state.params, gnorm=gnorm)
        metrics = {"loss": loss, "lr": lr, "step": new_opt.step}
        return TrainState(params=new_params, opt=new_opt,
                          ef_err=state.ef_err), metrics

    return step


def _label_weights(labels: torch.Tensor, accum: int, mesh,
                   axes: Tuple[str, ...]) -> torch.Tensor:
    """Each microbatch's weight on this device, (``accum``,): its count of
    labels >= 0 (what ``cross_entropy`` divides by) over that count summed
    over ``axes``, at least 1, as JAX's global mean
    divides by ``max(valid.sum(), 1)``.  Devices off the batch axes hold
    the same rows, so they add to the sum and the count alike and the
    weighted sum over ``axes`` is the global mean; the devices of a
    tensor-parallel axis each compute the whole loss of their rows, and
    are not summed over.  On one rank every weight is 1."""
    valid = (labels >= 0).reshape(accum, -1).sum(1).float()
    total = comm.all_reduce(valid.clone(), mesh, axes)
    return valid / total.clamp_min(1)


def make_eval_step(cfg: ArchConfig) -> Callable:
    loss_fn = api.loss_fn(cfg)

    def step(params, batch):
        with torch.no_grad():
            return loss_fn(params, batch)
    return step


def make_prefill_step(cfg: ArchConfig, cache_len: int, mesh=None,
                      rules: Optional[shd.AxisRules] = None,
                      global_batch: Optional[int] = None) -> Callable:
    """(params, batch) -> (last logits, cache); on a mesh the params are
    this device's blocks and the batch its rows (``global_batch`` of them
    in all; needed for a MoE model)."""
    gather, groups, tp = _param_gather(cfg, mesh, rules, global_batch)
    fn = api.prefill_fn(cfg, cache_len, **_cache_heads(cfg, tp))

    def step(params, batch):
        with torch.no_grad(), shd.use_row_groups(groups), \
                shd.use_blocks(mesh is not None), \
                tensor.use(_for_batch(tp, cfg, batch)):
            return fn(gather(params), batch)
    return step


def make_serve_step(cfg: ArchConfig, mesh=None,
                    rules: Optional[shd.AxisRules] = None,
                    global_batch: Optional[int] = None) -> Callable:
    """One decode tick: greedy-sample next token and advance the cache;
    on a mesh the params are this device's blocks, the batch and the
    cache its rows (``global_batch`` of them in all; needed for a MoE
    model)."""
    fn = api.decode_fn(cfg)
    gather, groups, tp = _param_gather(cfg, mesh, rules, global_batch)

    def step(params, batch, cache):
        with torch.no_grad(), shd.use_row_groups(groups), \
                shd.use_blocks(mesh is not None), tensor.use(tp):
            logits, new_cache = fn(gather(params), batch["token"], cache,
                                   batch["kv_len"])
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return {"token": next_tok, "kv_len": batch["kv_len"] + 1}, new_cache

    return step


def _cache_heads(cfg, tp: Optional[tensor.TensorParallel]) -> Dict:
    """The heads of a decode cache in a step of context ``tp``, as
    ``api.cache_spec``'s keywords: ``kv_heads``, the KV heads this
    device's query heads read (of the encoder-decoder's self and cross
    caches both; MLA's latent cache has no heads, and stays whole over
    "model"), and in a hybrid ``ssm_heads``, the Mamba2 heads
    it computes (``tensor.applies`` admits a hybrid only where they divide
    the axis); none off tensor parallelism (every head)."""
    if tp is None:
        return {}
    out = {}
    if cfg.attn != "mla":
        out["kv_heads"] = attention.local_kv_heads(tp, cfg.n_heads,
                                                   cfg.n_kv_heads)
    if cfg.family == "hybrid":
        out["ssm_heads"] = \
            cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim // tp.size
    return out


def _param_gather(cfg, mesh, rules, global_batch
                  ) -> Tuple[Callable, Any, Optional[tensor.TensorParallel]]:
    """(params -> the params the layers take, the step's row groups, its
    tensor-parallel context): on a mesh each stacked leaf one layer at a
    time, each layer gathered in its turn inside its body, and every
    other leaf gathered whole (``sharding.for_layers``), or under tensor
    parallelism each leaf's block of the "model" axis."""
    if mesh is None:
        return (lambda params: params), None, None
    rules = _rules(cfg, mesh, rules)
    lays = state_layouts(cfg, mesh, rules).params
    tp, keep = _tensor_parallel(cfg, mesh, rules, lays, global_batch)
    return (lambda params: shd.for_layers(params, lays, keep)), \
        _row_groups(cfg, mesh, rules, global_batch), tp


# ---------------------------------------------------------------------------
# A device's step arguments without storage (the dry run's)
# ---------------------------------------------------------------------------


def batch_axes(cfg: ArchConfig, shape: InputShape):
    """Logical axes tree for one batch (matches api.input_spec)."""
    return {k: v.axes for k, v in api.input_spec(cfg, shape).items()}


def _placed(spec, mesh, rules, rows_only: bool, device):
    fn = None
    if mesh is not None and rules is not None:
        fn = lambda axes, shape: shd.Layout(
            mesh, rules, shd.rows_axes(axes) if rows_only else tuple(axes),
            tuple(shape)).local_shape
    return abstract_params(spec, fn, device)


def abstract_batch(cfg: ArchConfig, shape: InputShape, mesh=None,
                   rules: Optional[shd.AxisRules] = None, accum: int = 1,
                   device="meta"):
    """This device's rows of a batch (whole rows: a split stream is cut
    after the embedding), with a leading microbatch axis under
    ``accum``."""
    spec = api.input_spec(cfg, shape)
    if accum > 1:
        spec = {k: ParamSpec((accum, v.shape[0] // accum) + v.shape[1:],
                             (None,) + v.axes, v.dtype)
                for k, v in spec.items()}
    return _placed(spec, mesh, rules, True, device)


def abstract_state(cfg: ArchConfig, mesh=None,
                   rules: Optional[shd.AxisRules] = None, device="meta"):
    """This device's blocks of the training state."""
    return _placed(train_state_spec(cfg), mesh, rules, False, device)


def abstract_cache(cfg: ArchConfig, shape: InputShape, mesh=None,
                   rules: Optional[shd.AxisRules] = None, device="meta"):
    """This device's rows of the decode cache (under tensor parallelism,
    of the KV heads its query heads read and of its Mamba2 heads), made
    as the models make a cache (``transformer.init_cache``: MLA's two
    leaves views of one buffer)."""
    tp = None
    if mesh is not None and rules is not None:
        tp, _ = _tensor_parallel(cfg, mesh, rules,
                                 state_layouts(cfg, mesh, rules).params,
                                 shape.global_batch)
    spec = api.cache_spec(cfg, shape, **_cache_heads(cfg, tp))
    if mesh is not None and rules is not None:
        spec = tree_map(lambda s: ParamSpec(shd.Layout(
            mesh, rules, shd.rows_axes(s.axes), tuple(s.shape)).local_shape,
            s.axes, s.dtype, init=s.init), spec)
    return init_cache(spec, device)


def materialize_batch(cfg: ArchConfig, shape: InputShape, seed: int = 0,
                      accum: int = 1, device=None) -> Dict[str, Any]:
    """Synthetic concrete batch matching ``input_spec``: the JAX package's
    numbers for the same seed, on ``device`` (the GPU unless named)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in api.input_spec(cfg, shape).items():
        shp = ((accum, s.shape[0] // accum) + s.shape[1:]) if accum > 1 \
            else s.shape
        if s.dtype == torch.int32:
            hi = cfg.vocab if "token" in k or "label" in k else 2
            out[k] = torch.as_tensor(
                rng.integers(0, hi, size=shp, dtype=np.int64)).to(
                    torch.int32)
        else:
            out[k] = torch.as_tensor(rng.normal(size=shp)).to(s.dtype)
    if "kv_len" in out:
        out["kv_len"] = torch.full(out["kv_len"].shape, shape.seq_len - 1,
                                   dtype=torch.int32)
    return {k: v.to(dev) for k, v in out.items()}
