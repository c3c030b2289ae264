"""Family-dispatch API of the port, after ``repro/models/api.py``.

  param_spec(cfg)                    ParamSpec tree of the model
  prefill_fn(cfg, cache_len)(params, batch)          (last_logits, cache)
  decode_fn(cfg)(params, token, cache, kv_len)       (logits, cache)
  cache_spec(cfg, shape)             ParamSpec tree of the decode cache

Decoder-only families only; ``transformer`` raises for those not yet
ported.
"""
from __future__ import annotations

from typing import Callable

from ..configs.base import ArchConfig, InputShape
from . import transformer as tf


def _decoder_only(cfg: ArchConfig) -> None:
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            f"(see ROADMAP.md)")


def param_spec(cfg: ArchConfig):
    _decoder_only(cfg)
    return tf.lm_spec(cfg)


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
