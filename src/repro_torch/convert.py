"""Convert the JAX package's trees (parameters, caches, training states)
into the port's.

The port keeps the JAX package's names and layouts, so conversion is a
key-for-key copy of leaves; a decode cache goes through
``cache_from_numpy``, which lays MLA's latent pair out as the port does.  Leaves arrive as numpy arrays
(``np.asarray`` of a JAX array); bfloat16 arrives as the ``ml_dtypes``
numpy type, which torch cannot read directly, and goes over as its bits.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .optim import OptState
from .parallel.steps import TrainState


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a)     # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Any, device) -> Any:
    """Nested dict of array leaves -> the same nesting of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def cache_from_numpy(tree: Any, device) -> Any:
    """A JAX decode cache with numpy leaves -> the port's, key for key;
    each MLA {"ckv", "krope"} pair becomes two views of one buffer, as
    ``models.transformer.init_cache`` lays it out."""
    if not isinstance(tree, dict):
        return tensor_from_numpy(tree, device)
    if tree.keys() == {"ckv", "krope"}:
        ckv = tensor_from_numpy(tree["ckv"], device)
        buf = torch.cat([ckv, tensor_from_numpy(tree["krope"], device)],
                        dim=-1)
        return {"ckv": buf[..., :ckv.shape[-1]],
                "krope": buf[..., ckv.shape[-1]:]}
    return {k: cache_from_numpy(v, device) for k, v in tree.items()}


def train_state_from_numpy(state: Any, device) -> TrainState:
    """The JAX package's ``TrainState`` with numpy leaves (params, opt.step,
    opt.master, opt.m, opt.v, and ef_err or None) -> the port's, on
    ``device``."""
    opt = state.opt

    def tree(t):
        return None if t is None else params_from_numpy(t, device)
    return TrainState(
        params=tree(state.params),
        opt=OptState(step=tensor_from_numpy(opt.step, device),
                     master=tree(opt.master), m=tree(opt.m), v=tree(opt.v)),
        ef_err=tree(state.ef_err))
