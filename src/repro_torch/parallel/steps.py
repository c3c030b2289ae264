"""Train and eval steps on one device, after ``repro/parallel/steps.py``.

The single-device part of the JAX module: the training state, its spec,
its initialisation, the train step (value and grad, microbatch
accumulation, error-feedback gradient compression, warmup-cosine lr,
AdamW) and the eval step.  The mesh, sharding constraints and the
``abstract_*`` dry-run helpers are later work (ROADMAP.md); on one device
the JAX package's constraints are no-ops.

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
from ..models import api
from ..models.common import ParamSpec, init_params, spec_map
from ..optim import (adamw_init, adamw_init_spec, adamw_update,
                     error_feedback_update, linear_warmup_cosine)
from ..tree import leaves, tree_map, unflatten


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


def make_train_step(cfg: ArchConfig, *, base_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    accum: int = 1, compress_fraction: Optional[float] = None
                    ) -> Callable:
    """(TrainState, batch) -> (TrainState, metrics).

    ``accum`` > 1 expects batch leaves with a leading microbatch axis and
    accumulates their gradients in fp32 in order, as JAX's ``lax.scan``
    does.  ``compress_fraction`` enables error-feedback top-k + int8
    gradient compression (``optim.compression``).
    """
    loss_fn = api.loss_fn(cfg)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        params = state.params
        if accum > 1:
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            loss = 0.0
            for i in range(accum):
                l, g = loss_and_grads(loss_fn, params,
                                      {k: v[i] for k, v in batch.items()})
                torch._foreach_add_(leaves(grads), leaves(g))
                loss = loss + l
            torch._foreach_div_(leaves(grads), accum)
            loss = loss / accum
        else:
            loss, grads = loss_and_grads(loss_fn, params, batch)

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


def make_eval_step(cfg: ArchConfig) -> Callable:
    loss_fn = api.loss_fn(cfg)

    def step(params, batch):
        with torch.no_grad():
            return loss_fn(params, batch)
    return step


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
