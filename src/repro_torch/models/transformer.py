"""Decoder-only LM for the dense family, after ``repro/models/transformer.py``.

  lm_spec(cfg)                                -> ParamSpec tree
  lm_forward(cfg, params, tokens)             -> logits
  lm_prefill(cfg, params, tokens, cache_len)  -> (last_logits, cache)
  lm_decode(cfg, params, token, cache, kv_len) -> (logits, cache)

Layers are stacked on a leading "layers" axis as in the JAX package; the
JAX ``lax.scan`` over layers is a Python loop over views of the stacked
tensors here.  Sharding constraints (no-ops without a mesh) are dropped.
The other families (MoE, MLA, hybrid, xLSTM, VLM) are later slices of the
port (ROADMAP.md) and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict

import torch

from .attention import gqa_decode_layer, gqa_layer, gqa_spec
from .common import (ParamSpec, embed, embed_spec, init_params,
                     mask_padded_vocab, rmsnorm, rmsnorm_spec, spec_map,
                     swiglu, swiglu_spec, unembed)


def _require_dense(cfg) -> None:
    if cfg.family != "dense" or cfg.attn != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with {cfg.attn!r} attention "
            f"is not ported yet (see ROADMAP.md); the port runs the dense "
            f"GQA decoder")


def stack_specs(tree, n: int):
    """Prepend a ('layers',) axis of size n to every leaf spec."""
    return spec_map(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                            dtype=s.dtype, init=s.init, scale=s.scale), tree)


def _layers(tree, n: int):
    """Views of layer i of a stacked tree, for i in range(n)."""
    def take(t, i):
        return t[i] if isinstance(t, torch.Tensor) else \
            {k: take(v, i) for k, v in t.items()}
    return [take(tree, i) for i in range(n)]


def block_spec(cfg) -> Dict:
    return {"ln1": rmsnorm_spec(cfg.d_model), "ln2": rmsnorm_spec(cfg.d_model),
            "attn": gqa_spec(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.dh),
            "ffn": swiglu_spec(cfg.d_model, cfg.d_ff)}


def block_apply(cfg, p, x, positions):
    """One pre-norm block over a sequence; returns ``(x, k, v)`` with the
    layer's rotated K/V for the prefill cache."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, k, v = gqa_layer(p["attn"], h, positions, impl=cfg.attn_impl,
                        rope_theta=cfg.rope_theta, chunk=cfg.attn_chunk)
    x = x + a
    x = x + swiglu(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x, k, v


def block_decode(cfg, p, x, cache, position, kv_len):
    """One block for one token; updates ``cache`` ({"k","v"}) in place."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, _, _ = gqa_decode_layer(p["attn"], h, cache["k"], cache["v"],
                               position, kv_len, cfg.rope_theta)
    x = x + a
    return x + swiglu(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps))


def lm_spec(cfg) -> Dict:
    _require_dense(cfg)
    return {"embed": embed_spec(cfg.padded_vocab, cfg.d_model),
            "final_norm": rmsnorm_spec(cfg.d_model),
            "blocks": stack_specs(block_spec(cfg), cfg.n_layers)}


def decode_cache_spec(cfg, batch: int, cache_len: int) -> Dict:
    _require_dense(cfg)
    kv = ParamSpec((batch, cache_len, cfg.n_kv_heads, cfg.dh),
                   ("batch", "kv_seq", "kv", None), cfg.torch_dtype,
                   init="zeros")
    return {"layers": stack_specs({"k": kv, "v": kv}, cfg.n_layers)}


def _trunk(cfg, params, tokens, cache=None):
    """Embedding and blocks; writes each layer's K/V into ``cache`` when
    one is given."""
    x = embed(params["embed"], tokens).to(cfg.torch_dtype)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, device=x.device).expand(b, s)
    for i, p in enumerate(_layers(params["blocks"], cfg.n_layers)):
        x, k, v = block_apply(cfg, p, x, positions)
        if cache is not None:
            cache["layers"]["k"][i, :, :s] = k
            cache["layers"]["v"][i, :, :s] = v
    return x


def lm_forward(cfg, params, tokens):
    """Full-sequence logits. tokens:(B,S) -> (B,S,V)."""
    _require_dense(cfg)
    x = rmsnorm(params["final_norm"], _trunk(cfg, params, tokens),
                cfg.norm_eps)
    return mask_padded_vocab(unembed(params["embed"], x), cfg.vocab)


def lm_prefill(cfg, params, tokens, cache_len: int):
    """Process the prompt; return (last-token logits (B,V), cache).

    Each layer's K/V is computed once, in the attention, and written into
    a zero cache of ``cache_len`` rows.
    """
    _require_dense(cfg)
    b, s = tokens.shape
    if s > cache_len:
        raise ValueError(f"prompt of {s} tokens over cache_len {cache_len}")
    cache = init_params(decode_cache_spec(cfg, b, cache_len), None,
                        tokens.device)
    x = _trunk(cfg, params, tokens, cache)
    x = rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    logits = mask_padded_vocab(unembed(params["embed"], x)[:, 0], cfg.vocab)
    return logits, cache


def lm_decode(cfg, params, token, cache, kv_len):
    """One decode step. token:(B,1) int; kv_len:(B,) int32 cache fill.

    Returns (logits (B,V), cache); the cache is updated in place.
    """
    _require_dense(cfg)
    x = embed(params["embed"], token).to(cfg.torch_dtype)
    layer_caches = _layers(cache["layers"], cfg.n_layers)
    for p, c in zip(_layers(params["blocks"], cfg.n_layers), layer_caches):
        x = block_decode(cfg, p, x, c, kv_len, kv_len)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = mask_padded_vocab(unembed(params["embed"], x[:, 0]), cfg.vocab)
    return logits, cache
