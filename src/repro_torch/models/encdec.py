"""Encoder-decoder backbone (Whisper-medium class), after
``repro/models/encdec.py``.

The audio conv frontend is a stub, as in the JAX package: the inputs are
precomputed frame embeddings (B, n_frames, D).  The backbone is a
bidirectional encoder stack and a causal decoder stack with
cross-attention; layers are a Python loop over views of the stacked
tensors (the JAX ``lax.scan``), each under ``cfg.remat`` on the plain
(training) route, as JAX's ``_remat`` wraps them.  In a mesh step each
layer's body gathers its own weights (``sharding.layer``), inside what
remat checkpoints; the prefill gathers each decoder layer's
cross-attention weights in its turn.

Attention follows ``cfg.attn_impl``: under "kernel" the encoder's
self-attention (non-causal), the decoder's (causal, S = T) and the
training decoder's cross-attention go through ``ops.flash_attention``;
"chunked" and "full" are the plain paths (the JAX package runs
``attend_chunked`` here whatever ``attn_impl`` says).  Serving: the
prefill encodes, projects each decoder layer's cross K/V once and starts
an empty self cache; a decode step runs the decoder's self-attention
through ``gqa_decode_layer`` (``ops.flash_decode`` over the ``dec_len``
cache) and its cross-attention through ``ops.flash_decode`` over every
encoder frame.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..kernels import ops
from ..parallel.sharding import layer
from .attention import (attend_chunked, attend_full, gqa_decode_layer,
                        gqa_output, gqa_project_qkv, gqa_spec)
from .common import (ParamSpec, cross_entropy, embed, embed_spec,
                     init_params, mask_padded_vocab, rmsnorm, rmsnorm_spec,
                     swiglu, swiglu_spec, unembed)
from .transformer import _attn_cache_spec, _layers, _remat, stack_specs


def _enc_block_spec(cfg) -> Dict:
    return {"ln1": rmsnorm_spec(cfg.d_model), "ln2": rmsnorm_spec(cfg.d_model),
            "attn": gqa_spec(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh),
            "ffn": swiglu_spec(cfg.d_model, cfg.d_ff)}


def _dec_block_spec(cfg) -> Dict:
    sp = _enc_block_spec(cfg)
    sp["ln_x"] = rmsnorm_spec(cfg.d_model)
    sp["xattn"] = gqa_spec(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh)
    return sp


def encdec_spec(cfg) -> Dict:
    return {
        "embed": embed_spec(cfg.padded_vocab, cfg.d_model),
        "dec_pos": ParamSpec((cfg.dec_len, cfg.d_model), (None, "embed"),
                             scale=0.02),
        "enc_blocks": stack_specs(_enc_block_spec(cfg), cfg.n_layers),
        "dec_blocks": stack_specs(_dec_block_spec(cfg), cfg.n_dec_layers),
        "enc_norm": rmsnorm_spec(cfg.d_model),
        "final_norm": rmsnorm_spec(cfg.d_model),
    }


def _attend(cfg, q, k, v, causal: bool):
    if cfg.attn_impl == "kernel":
        return ops.flash_attention(q, k, v, causal=causal)
    if cfg.attn_impl == "full":
        return attend_full(q, k, v, causal=causal)
    if cfg.attn_impl == "chunked":
        return attend_chunked(q, k, v, causal=causal, chunk=cfg.attn_chunk)
    raise ValueError(f"unknown attention impl {cfg.attn_impl!r}")


def _self_attn(cfg, p, x, positions, causal: bool):
    q, k, v = gqa_project_qkv(p, x, positions, cfg.rope_theta)
    return gqa_output(p, _attend(cfg, q, k, v, causal))


def cross_kv(cfg, p, enc_out):
    k = torch.einsum("bsd,dnk->bsnk", enc_out, p["wk"])
    v = torch.einsum("bsd,dnk->bsnk", enc_out, p["wv"])
    return k, v


def _cross_attn(cfg, p, x, enc_k, enc_v):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    return gqa_output(p, _attend(cfg, q, enc_k, enc_v, False))


def _positions(x):
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device).expand(b, s)


def _enc_block(cfg, p, h, positions, plain):
    p = layer(p)
    h = h + _self_attn(cfg, p["attn"],
                       rmsnorm(p["ln1"], h, cfg.norm_eps, plain=plain),
                       positions, causal=False)
    return h + swiglu(p["ffn"], rmsnorm(p["ln2"], h, cfg.norm_eps,
                                        plain=plain))


def encode(cfg, params, frames, *, plain: bool = False):
    """frames: (B, S_enc, D) precomputed embeddings (stub frontend)."""
    x = frames.to(cfg.torch_dtype)
    positions = _positions(x)
    run = _remat(cfg) if plain else (lambda fn, *args: fn(*args))
    for p in _layers(params["enc_blocks"], cfg.n_layers):
        x = run(_enc_block, cfg, p, x, positions, plain)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps, plain=plain)


def _dec_block(cfg, p, h, positions, enc_out, plain):
    p = layer(p)
    h = h + _self_attn(cfg, p["attn"],
                       rmsnorm(p["ln1"], h, cfg.norm_eps, plain=plain),
                       positions, causal=True)
    ek, ev = cross_kv(cfg, p["xattn"], enc_out)
    h = h + _cross_attn(cfg, p["xattn"],
                        rmsnorm(p["ln_x"], h, cfg.norm_eps, plain=plain),
                        ek, ev)
    return h + swiglu(p["ffn"], rmsnorm(p["ln2"], h, cfg.norm_eps,
                                        plain=plain))


def decode_train(cfg, params, enc_out, dec_tokens, *, plain: bool = False):
    """Teacher-forced decoder: (B, S_dec) -> logits (B, S_dec, V)."""
    sd = dec_tokens.shape[1]
    x = embed(params["embed"], dec_tokens).to(cfg.torch_dtype)
    x = x + params["dec_pos"][None, :sd].to(cfg.torch_dtype)
    positions = _positions(x)
    run = _remat(cfg) if plain else (lambda fn, *args: fn(*args))
    for p in _layers(params["dec_blocks"], cfg.n_dec_layers):
        x = run(_dec_block, cfg, p, x, positions, enc_out, plain)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps, plain=plain)
    return mask_padded_vocab(unembed(params["embed"], x), cfg.vocab)


def encdec_loss(cfg, params, batch):
    """batch: {'frames': (B,S,D), 'dec_tokens': (B,Sd), 'labels': (B,Sd)},
    through the training (plain) route."""
    enc = encode(cfg, params, batch["frames"], plain=True)
    logits = decode_train(cfg, params, enc, batch["dec_tokens"], plain=True)
    return cross_entropy(logits, batch["labels"])


# ---------------------------------------------------------------------------
# Serving: prefill = encode + cross-KV + BOS; decode = 1 token/step
# ---------------------------------------------------------------------------


def encdec_cache_spec(cfg, batch: int, enc_len: int) -> Dict:
    dt = cfg.torch_dtype
    cross = ParamSpec((cfg.n_dec_layers, batch, enc_len, cfg.n_kv_heads,
                       cfg.dh), ("layers", "batch", "kv_seq", "kv", None), dt,
                      init="zeros")
    return {"self": stack_specs(_attn_cache_spec(cfg, batch, cfg.dec_len),
                                cfg.n_dec_layers),
            "cross_k": cross, "cross_v": cross}


def encdec_prefill(cfg, params, frames):
    """Encode audio; build every decoder layer's cross K/V; return the
    cache with an empty self cache."""
    enc = encode(cfg, params, frames)
    b, s = enc.shape[:2]
    cache = init_params(encdec_cache_spec(cfg, b, s), None, enc.device)
    for i, p in enumerate(_layers(params["dec_blocks"], cfg.n_dec_layers)):
        k, v = cross_kv(cfg, layer(p["xattn"]), enc)
        cache["cross_k"][i] = k
        cache["cross_v"][i] = v
    return cache


def encdec_decode(cfg, params, token, cache, kv_len):
    """One decoder token. token:(B,1); kv_len:(B,) int32 decoder cache
    fill.  Returns (logits (B,V), cache); the self cache is updated in
    place."""
    b = token.shape[0]
    x = embed(params["embed"], token).to(cfg.torch_dtype)
    pos = params["dec_pos"][kv_len.long().clamp(0, cfg.dec_len - 1)]
    x = x + pos[:, None, :].to(cfg.torch_dtype)
    enc_len = torch.full((b,), cache["cross_k"].shape[2], dtype=torch.int32,
                         device=x.device)
    n = cfg.n_dec_layers
    for p, c, xk, xv in zip(_layers(params["dec_blocks"], n),
                            _layers(cache["self"], n),
                            _layers(cache["cross_k"], n),
                            _layers(cache["cross_v"], n)):
        p = layer(p)
        hn = rmsnorm(p["ln1"], x, cfg.norm_eps)
        a, _, _ = gqa_decode_layer(p["attn"], hn, c["k"], c["v"], kv_len,
                                   kv_len, cfg.rope_theta)
        x = x + a
        hn = rmsnorm(p["ln_x"], x, cfg.norm_eps)
        q = torch.einsum("bsd,dhk->bshk", hn, p["xattn"]["wq"])
        x = x + gqa_output(p["xattn"], ops.flash_decode(q, xk, xv, enc_len))
        x = x + swiglu(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = mask_padded_vocab(unembed(params["embed"], x[:, 0]), cfg.vocab)
    return logits, cache
