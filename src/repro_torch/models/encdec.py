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

Inside a tensor-parallel mesh step (``parallel.tensor``) the self- and
cross-attention take this device's block of the query heads and the KV
heads they read (``attention.kv_weights``), the SwiGLU its block of the
hidden width and the embedding its vocab rows; each sums its partial
output over the axis, the loss takes the logits cut by vocab and the
decode gathers them whole.  The encoder's stream and the decoder's are
each split by rows over the axis where the rules split a stream of their
length (``TensorParallel.for_stream``; Whisper's 1500 frames stay whole
on 16 devices, its 448 tokens split), with the positions of the whole
sequence.  The encoder's output leaves :func:`encode` whole, gathered
over its rows, for the cross K/V of every decoder layer.  The cross
cache holds the KV heads a device's query heads read (``kv_heads=``, as
the self cache does), wherever the heads are split.  JAX's rules cut it
by "kv_seq" instead, and only where the frames divide the axis: at
Whisper's 1500 frames on 16 devices JAX keeps it whole on every device.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..kernels import ops
from ..parallel import tensor
from ..parallel.sharding import layer
from .attention import (attend_chunked, attend_full, gqa_decode_layer,
                        gqa_output, gqa_project_qkv, gqa_spec, head_split,
                        heads_input, kv_weights, local_kv_heads)
from .common import (ParamSpec, cross_entropy, embed, embed_spec,
                     init_params, mask_padded_vocab, rmsnorm, rmsnorm_spec,
                     swiglu, swiglu_spec, unembed, vocab_split, vocab_start)
from .transformer import (_attn_cache_spec, _layers, _remat, _whole_logits,
                          stack_specs)


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
    """The cross-attention's K and V of :func:`encode`'s whole output:
    every KV head, or under a head split those this device's query heads
    read (``attention.kv_weights``)."""
    wk, wv = kv_weights(p, head_split(p))
    k = torch.einsum("bsd,dnk->bsnk", enc_out, wk)
    v = torch.einsum("bsd,dnk->bsnk", enc_out, wv)
    return k, v


def _cross_query(p, x):
    """The cross-attention's queries of the decoder's stream ``x``: every
    head, or this device's under a head split, of the whole sequence
    (``attention.heads_input``)."""
    return torch.einsum("bsd,dhk->bshk", heads_input(x, head_split(p)),
                        p["wq"])


def _cross_attn(cfg, p, x, enc_k, enc_v):
    q = _cross_query(p, x)
    return gqa_output(p, _attend(cfg, q, enc_k, enc_v, False))


def _stream(b: int, s: int, d: int) -> Optional[tensor.TensorParallel]:
    """The active tensor-parallel context for a stream of (B, S, D): split
    by rows where the rules split a stream of that shape; None off it."""
    tp = tensor.active()
    return None if tp is None else tp.for_stream((b, s, d))


def _positions(x):
    """The positions of the stream ``x`` (B, S, ...): of the whole
    sequence where ``x`` is this device's rows of a split stream
    (``tensor.seq_split``), which attention sees gathered."""
    b, s = x.shape[:2]
    sp = tensor.seq_split()
    if sp is not None:
        s *= sp.size
    return torch.arange(s, device=x.device).expand(b, s)


def _enc_block(cfg, p, h, positions, plain, stream):
    # ``stream`` is set here, not only around the loop: remat's
    # recompute runs this body again in the backward
    with tensor.use(stream):
        p = layer(p)
        h = h + _self_attn(cfg, p["attn"],
                           rmsnorm(p["ln1"], h, cfg.norm_eps, plain=plain),
                           positions, causal=False)
        return h + swiglu(p["ffn"], rmsnorm(p["ln2"], h, cfg.norm_eps,
                                            plain=plain))


def encode(cfg, params, frames, *, plain: bool = False):
    """frames: (B, S_enc, D) precomputed embeddings (stub frontend).

    Under tensor parallelism the encoder's stream is this device's rows
    where the rules split a stream of S_enc rows, and the output comes
    back whole for the cross K/V of this device's heads: gathered over
    the rows (the gradient reduce-scattered back), or entering the split
    (the gradient summed over the axis)."""
    x = frames.to(cfg.torch_dtype)
    stream = _stream(*x.shape)
    with tensor.use(stream):
        sp = tensor.seq_split()
        if sp is not None:
            x = tensor.split_seq(x, sp)
        positions = _positions(x)
        run = _remat(cfg) if plain else (lambda fn, *args: fn(*args))
        for p in _layers(params["enc_blocks"], cfg.n_layers):
            x = run(_enc_block, cfg, p, x, positions, plain, stream)
        x = rmsnorm(params["enc_norm"], x, cfg.norm_eps, plain=plain)
        return x if stream is None else heads_input(x, stream)


def _dec_block(cfg, p, h, positions, enc_out, plain, stream):
    with tensor.use(stream):
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
    """Teacher-forced decoder: (B, S_dec) -> logits (B, S_dec, V), or this
    device's vocab block of them (B, S_dec, V/m) under a vocab split.
    ``enc_out`` is :func:`encode`'s.  Under tensor parallelism the
    decoder's stream is this device's rows where the rules split a stream
    of S_dec rows, its position rows added to them."""
    b, sd = dec_tokens.shape
    stream = _stream(b, sd, cfg.d_model)
    with tensor.use(stream):
        sp = tensor.seq_split()
        x = embed(params["embed"], dec_tokens).to(cfg.torch_dtype)
        pos = params["dec_pos"][None, :sd].to(cfg.torch_dtype)
        x = x + (pos if sp is None else tensor.split_seq(pos, sp))
        positions = _positions(x)
        run = _remat(cfg) if plain else (lambda fn, *args: fn(*args))
        for p in _layers(params["dec_blocks"], cfg.n_dec_layers):
            x = run(_dec_block, cfg, p, x, positions, enc_out, plain, stream)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps, plain=plain)
        return mask_padded_vocab(unembed(params["embed"], x), cfg.vocab,
                                 vocab_start(params["embed"]))


def encdec_loss(cfg, params, batch):
    """batch: {'frames': (B,S,D), 'dec_tokens': (B,Sd), 'labels': (B,Sd)},
    through the training (plain) route."""
    enc = encode(cfg, params, batch["frames"], plain=True)
    logits = decode_train(cfg, params, enc, batch["dec_tokens"], plain=True)
    return cross_entropy(logits, batch["labels"],
                         split=vocab_split(params["embed"]))


# ---------------------------------------------------------------------------
# Serving: prefill = encode + cross-KV + BOS; decode = 1 token/step
# ---------------------------------------------------------------------------


def encdec_cache_spec(cfg, batch: int, enc_len: int,
                      kv_heads: Optional[int] = None) -> Dict:
    """The decode cache of ``batch`` rows: the decoder's self K/V of
    ``dec_len`` rows and the cross K/V of ``enc_len`` frames, each of
    ``kv_heads`` heads (a tensor-parallel device's, ``parallel.steps``),
    every KV head where not given."""
    dt = cfg.torch_dtype
    n = cfg.n_kv_heads if kv_heads is None else kv_heads
    cross = ParamSpec((cfg.n_dec_layers, batch, enc_len, n, cfg.dh),
                      ("layers", "batch", "kv_seq", "kv", None), dt,
                      init="zeros")
    return {"self": stack_specs(_attn_cache_spec(cfg, batch, cfg.dec_len,
                                                 kv_heads),
                                cfg.n_dec_layers),
            "cross_k": cross, "cross_v": cross}


def encdec_prefill(cfg, params, frames, kv_heads: Optional[int] = None):
    """Encode audio; build every decoder layer's cross K/V; return the
    cache with an empty self cache, its K/V of ``kv_heads`` heads
    (:func:`encdec_cache_spec`)."""
    enc = encode(cfg, params, frames)
    b, s = enc.shape[:2]
    cache = init_params(encdec_cache_spec(cfg, b, s, kv_heads), None,
                        enc.device)
    for i, p in enumerate(_layers(params["dec_blocks"], cfg.n_dec_layers)):
        k, v = cross_kv(cfg, layer(p["xattn"]), enc)
        cache["cross_k"][i] = k
        cache["cross_v"][i] = v
    return cache


def encdec_decode(cfg, params, token, cache, kv_len):
    """One decoder token. token:(B,1); kv_len:(B,) int32 decoder cache
    fill.  Returns (logits (B,V), cache); the self cache is updated in
    place.  Under a head split the caches must hold the KV heads this
    device's query heads read."""
    b = token.shape[0]
    kv = local_kv_heads(tensor.active(), cfg.n_heads, cfg.n_kv_heads)
    if cache["cross_k"].shape[3] != kv:
        raise ValueError(f"a cross cache of {cache['cross_k'].shape[3]} KV "
                         f"heads for a decoder that computes {kv}")
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
        q = _cross_query(p["xattn"], rmsnorm(p["ln_x"], x, cfg.norm_eps))
        x = x + gqa_output(p["xattn"], ops.flash_decode(q, xk, xv, enc_len))
        x = x + swiglu(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _whole_logits(cfg, params, unembed(params["embed"], x[:, 0])), \
        cache
