"""Family-dispatch API of the port, after ``repro/models/api.py``.

  param_spec(cfg)                    ParamSpec tree of the model
  loss_fn(cfg)(params, batch)        scalar loss           [train shapes]
  prefill_fn(cfg, cache_len[, kv_heads, ssm_heads])(params, batch)
                                     (last_logits, cache)
  decode_fn(cfg)(params, token, cache, kv_len)       (logits, cache)
  input_spec(cfg, shape)             ParamSpec dict of batch inputs
  cache_spec(cfg, shape)             ParamSpec tree of the decode cache

The encoder-decoder family goes to ``encdec``, every other to
``transformer``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..configs.base import ArchConfig, InputShape
from . import encdec as ed
from . import transformer as tf
from .common import ParamSpec


def param_spec(cfg: ArchConfig):
    if cfg.family == "encdec":
        return ed.encdec_spec(cfg)
    return tf.lm_spec(cfg)


def loss_fn(cfg: ArchConfig) -> Callable:
    if cfg.family == "encdec":
        return lambda params, batch: ed.encdec_loss(cfg, params, batch)
    return lambda params, batch: tf.lm_loss(cfg, params, batch)


def prefill_fn(cfg: ArchConfig, cache_len: int,
               kv_heads: Optional[int] = None,
               ssm_heads: Optional[int] = None) -> Callable:
    """cache_len: the KV cache capacity to allocate (the encoder-decoder's
    self cache is ``dec_len`` rows, its cross cache the frames given);
    kv_heads, ssm_heads: the KV heads of a decoder's cache (the
    encoder-decoder's self and cross caches) and the Mamba2 heads of a
    hybrid's (every one where not given; a tensor-parallel device's,
    ``parallel.steps``)."""
    if cfg.family == "encdec":
        def _encdec_prefill(params, batch):
            cache = ed.encdec_prefill(cfg, params, batch["frames"],
                                      kv_heads)
            b = batch["frames"].shape[0]
            dev = batch["frames"].device
            bos = torch.zeros((b, 1), dtype=torch.long, device=dev)
            return ed.encdec_decode(cfg, params, bos, cache, torch.zeros(
                (b,), dtype=torch.int32, device=dev))
        return _encdec_prefill
    if cfg.family == "vlm":
        return lambda params, batch: tf.lm_prefill(
            cfg, params, batch["tokens"], cache_len,
            img_embeds=batch.get("img_embeds"), kv_heads=kv_heads)
    return lambda params, batch: tf.lm_prefill(
        cfg, params, batch["tokens"], cache_len, kv_heads=kv_heads,
        ssm_heads=ssm_heads)


def decode_fn(cfg: ArchConfig) -> Callable:
    if cfg.family == "encdec":
        return lambda params, token, cache, kv_len: ed.encdec_decode(
            cfg, params, token, cache, kv_len)
    return lambda params, token, cache, kv_len: tf.lm_decode(
        cfg, params, token, cache, kv_len)


def cache_spec(cfg: ArchConfig, shape: InputShape,
               kv_heads: Optional[int] = None,
               ssm_heads: Optional[int] = None):
    if cfg.family == "encdec":
        return ed.encdec_cache_spec(cfg, shape.global_batch, shape.seq_len,
                                    kv_heads)
    return tf.decode_cache_spec(cfg, shape.global_batch, shape.seq_len,
                                kv_heads, ssm_heads)


def input_spec(cfg: ArchConfig, shape: InputShape) -> Dict[str, ParamSpec]:
    """Shapes and dtypes of one batch for one cell, as the JAX package's
    ``input_spec``: a VLM takes p = min(n_img_patches, seq // 2) patch
    embeddings before seq - p tokens; an encoder-decoder takes seq_len
    encoder frames and, in training, ``dec_len`` decoder tokens."""
    b, s = shape.global_batch, shape.seq_len
    tok = ("batch", "seq")
    act = ("batch", "seq", "act_embed")
    if shape.kind == "decode":
        return {"token": ParamSpec((b, 1), tok, torch.int32),
                "kv_len": ParamSpec((b,), ("batch",), torch.int32)}
    if shape.kind not in ("train", "prefill"):
        raise ValueError(shape.kind)
    train = shape.kind == "train"
    if cfg.family == "encdec":
        spec = {"frames": ParamSpec((b, s, cfg.d_model), act,
                                    cfg.torch_dtype)}
        if train:
            spec["dec_tokens"] = ParamSpec((b, cfg.dec_len), tok,
                                           torch.int32)
            spec["labels"] = ParamSpec((b, cfg.dec_len), tok, torch.int32)
        return spec
    if cfg.family == "vlm":
        p = min(cfg.n_img_patches, s // 2)
        spec = {"tokens": ParamSpec((b, s - p), tok, torch.int32),
                "img_embeds": ParamSpec((b, p, cfg.d_model), act,
                                        cfg.torch_dtype)}
        if train:
            spec["labels"] = ParamSpec((b, s - p), tok, torch.int32)
        return spec
    spec = {"tokens": ParamSpec((b, s), tok, torch.int32)}
    if train:
        spec["labels"] = ParamSpec((b, s), tok, torch.int32)
    return spec
