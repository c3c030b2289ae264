"""Family-dispatch API of the port, after ``repro/models/api.py``.

  param_spec(cfg)                    ParamSpec tree of the model
  loss_fn(cfg)(params, batch)        scalar loss           [train shapes]
  prefill_fn(cfg, cache_len)(params, batch)          (last_logits, cache)
  decode_fn(cfg)(params, token, cache, kv_len)       (logits, cache)
  input_spec(cfg, shape)             ParamSpec dict of batch inputs
  cache_spec(cfg, shape)             ParamSpec tree of the decode cache

Decoder-only families only; ``transformer`` raises for those not yet
ported.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..configs.base import ArchConfig, InputShape
from . import transformer as tf
from .common import ParamSpec


def _decoder_only(cfg: ArchConfig) -> None:
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            f"(see ROADMAP.md)")


def param_spec(cfg: ArchConfig):
    _decoder_only(cfg)
    return tf.lm_spec(cfg)


def loss_fn(cfg: ArchConfig) -> Callable:
    _decoder_only(cfg)
    return lambda params, batch: tf.lm_loss(cfg, params, batch)


def prefill_fn(cfg: ArchConfig, cache_len: int) -> Callable:
    _decoder_only(cfg)
    return lambda params, batch: tf.lm_prefill(cfg, params, batch["tokens"],
                                               cache_len)


def decode_fn(cfg: ArchConfig) -> Callable:
    _decoder_only(cfg)
    return lambda params, token, cache, kv_len: tf.lm_decode(
        cfg, params, token, cache, kv_len)


def cache_spec(cfg: ArchConfig, shape: InputShape):
    _decoder_only(cfg)
    return tf.decode_cache_spec(cfg, shape.global_batch, shape.seq_len)


def input_spec(cfg: ArchConfig, shape: InputShape) -> Dict[str, ParamSpec]:
    """Shapes and dtypes of one batch of a decoder-only model (the JAX
    package's ``input_spec`` for those families)."""
    _decoder_only(cfg)
    if cfg.family == "vlm":
        raise NotImplementedError(f"{cfg.name}: VLM models are not ported "
                                  f"yet (see ROADMAP.md)")
    b, s = shape.global_batch, shape.seq_len
    tok = ("batch", "seq")
    if shape.kind == "train":
        return {"tokens": ParamSpec((b, s), tok, torch.int32),
                "labels": ParamSpec((b, s), tok, torch.int32)}
    if shape.kind == "prefill":
        return {"tokens": ParamSpec((b, s), tok, torch.int32)}
    if shape.kind == "decode":
        return {"token": ParamSpec((b, 1), tok, torch.int32),
                "kv_len": ParamSpec((b,), ("batch",), torch.int32)}
    raise ValueError(shape.kind)
