"""Grouped-query attention, after ``repro/models/attention.py``.

Plain paths kept as references: ``attend_full`` (materialises the score
matrix), ``attend_chunked`` (online softmax over KV chunks) and
``attend_decode`` (one query token against a cache).  The model's own
path goes through the kernels: ``gqa_layer(impl="kernel")`` through
flash attention and ``gqa_decode_layer`` always through flash decode.

In a tensor-parallel mesh step (``parallel.tensor``) whose wq and wo are
this device's block of the heads, a layer computes those query heads,
the KV heads they read (a slice of the whole wk and wv) and the partial
output of its wo block, summed over the blocks; the decode takes a
cache of those KV heads, and raises on any other count.  On a stream
split by rows (``tensor.seq_split``) the projections take the gathered
sequence and the output's sums go back reduce-scattered; heads that stay
whole are computed whole by every device, which keeps its rows of the
output.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..kernels import ops
from ..parallel import tensor
from .common import ParamSpec, apply_rope

NEG_INF = -1e30
WQ_AXES = ("embed", "heads", None)
WKV_AXES = ("embed", "kv", None)
WO_AXES = ("heads", None, "embed")


def gqa_spec(d_model: int, n_heads: int, n_kv: int, head_dim: int,
             qk_head_dim: Optional[int] = None) -> Dict[str, ParamSpec]:
    qk = qk_head_dim or head_dim
    return {
        "wq": ParamSpec((d_model, n_heads, qk), WQ_AXES),
        "wk": ParamSpec((d_model, n_kv, qk), WKV_AXES),
        "wv": ParamSpec((d_model, n_kv, head_dim), WKV_AXES),
        "wo": ParamSpec((n_heads, head_dim, d_model), WO_AXES),
    }


def head_split(params) -> Optional[tensor.TensorParallel]:
    """The tensor-parallel context where wq and wo are this device's block
    of the heads, else None (off a mesh step, or heads that do not divide
    the axis: the layer runs whole)."""
    tp = tensor.active()
    if tp is None or tp.split_dim(params["wq"], WQ_AXES) is None:
        return None
    tp.split_dim(params["wo"], WO_AXES)
    for w in ("wk", "wv"):
        if tp.split_dim(params[w], WKV_AXES) is not None:
            raise NotImplementedError("wk and wv split over the model axis")
    return tp


def local_kv_heads(tp: Optional[tensor.TensorParallel], n_heads: int,
                   n_kv: int) -> int:
    """KV heads of a layer's cache in a mesh step of context ``tp``: those
    this device's query heads read where the heads are split, else
    ``n_kv``."""
    if tp is None or tp.dim_of(WQ_AXES) is None:
        return n_kv
    return len(tp.kv_heads(n_heads, n_kv))


def _repeat_kv(k, n_heads):
    """(B,T,Hkv,D) -> (B,T,H,D) by repeating each KV head G times."""
    n_kv = k.shape[2]
    return k if n_kv == n_heads else k.repeat_interleave(n_heads // n_kv,
                                                         dim=2)


def attend_full(q, k, v, *, causal: bool = True, q_offset: int = 0,
                scale: Optional[float] = None):
    """Reference attention. q:(B,Sq,H,Dq) k:(B,Sk,Hkv,Dq) v:(B,Sk,Hkv,Dv)."""
    sq, h, dq = q.shape[1], q.shape[2], q.shape[3]
    scale = scale if scale is not None else dq ** -0.5
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        kpos = torch.arange(k.shape[1], device=q.device)
        logits = logits.masked_fill(~(qpos[:, None] >= kpos[None, :]),
                                    NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", w.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def attend_chunked(q, k, v, *, causal: bool = True, chunk: int = 1024,
                   q_offset: int = 0, scale: Optional[float] = None):
    """Online-softmax attention, scanning KV in chunks (flash dataflow)."""
    b, sq, h, dq = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    scale = scale if scale is not None else dq ** -0.5
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    qpos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dv), dtype=torch.float32, device=q.device)
    for c0 in range(0, sk, chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        kpos = c0 + torch.arange(kb.shape[1], device=q.device)
        logits = torch.einsum("bshd,bthd->bhst", q.float(),
                              kb.float()) * scale
        if causal:
            logits = logits.masked_fill(~(qpos[:, None] >= kpos[None, :]),
                                        NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhst,bthd->bhsd", p.to(vb.dtype).float(), vb.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def attend_decode(q, k_cache, v_cache, kv_len=None,
                  scale: Optional[float] = None):
    """One-step decode: q (B,1,H,Dq) vs cache (B,T,Hkv,D*)."""
    b, _, h, dq = q.shape
    t, n_kv = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else dq ** -0.5
    qg = q[:, 0].reshape(b, n_kv, h // n_kv, dq)       # (B,N,G,D)
    logits = torch.einsum("bngd,btnd->bngt", qg.float(),
                          k_cache.float()) * scale
    if kv_len is not None:
        mask = torch.arange(t, device=q.device)[None] < kv_len[:, None]
        logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngt,btnd->bngd", w.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, h, v_cache.shape[-1]).to(q.dtype)


# ---------------------------------------------------------------------------
# Full GQA layer (projections + rope + attention + output)
# ---------------------------------------------------------------------------


def heads_input(x, tp: Optional[tensor.TensorParallel]):
    """The input of an attention layer's projections: under a head split
    ``tp`` the whole stream, its gradient summed over the axis
    (``into_split``), or gathered from this device's rows of a split
    stream (``gather_seq``); heads left whole take the whole sequence of
    a split stream as every device of the axis computes it (``copies``),
    and :func:`heads_output` keeps this device's rows."""
    sp = tensor.seq_split()
    if tp is not None:
        return tensor.into_split(x, tp) if sp is None \
            else tensor.gather_seq(x, sp)
    return x if sp is None else tensor.gather_seq(x, sp, copies=True)


def heads_output(y, tp: Optional[tensor.TensorParallel]):
    """An attention layer's output projection ``y``: under a head split
    ``tp`` this device's heads' partial sums, summed over the blocks; on
    a split stream this device's rows, the sums reduce-scattered or cut
    from every head's whole output."""
    sp = tensor.seq_split()
    if sp is None:
        return y if tp is None else tensor.out_of_split(y, tp)
    return tensor.split_seq(y, sp) if tp is None \
        else tensor.scatter_seq(y, sp)


def kv_weights(params, tp: Optional[tensor.TensorParallel]):
    """A layer's (wk, wv): whole, or under a head split ``tp``
    (:func:`head_split`) the KV heads this device's query heads read
    (``TensorParallel.kv_heads``), sliced from the whole leaves, whose
    gradients are summed over the axis."""
    wk, wv = params["wk"], params["wv"]
    if tp is None:
        return wk, wv
    heads = tp.kv_heads(params["wq"].shape[1] * tp.size, wk.shape[1])
    return tuple(tensor.into_split(w, tp).narrow(1, heads.start, len(heads))
                 for w in (wk, wv))


def _project(params, x):
    """Unrotated (q, k, v) of ``x``: every head, or under a head split
    (:func:`head_split`) this device's query heads and the KV heads they
    read (:func:`kv_weights`); of the whole sequence where ``x`` is this
    device's rows of a split stream."""
    tp = head_split(params)
    x = heads_input(x, tp)
    wk, wv = kv_weights(params, tp)
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dnk->bsnk", x, wk)
    v = torch.einsum("bsd,dnk->bsnk", x, wv)
    return q, k, v


def gqa_project_qkv(params, x, positions, rope_theta: float = 10000.0):
    q, k, v = _project(params, x)
    return (apply_rope(q, positions, rope_theta),
            apply_rope(k, positions, rope_theta), v)


def gqa_output(params, attn_out):
    """The output projection (:func:`heads_output`)."""
    return heads_output(torch.einsum("bshd,hdm->bsm", attn_out,
                                     params["wo"]), head_split(params))


def gqa_layer(params, x, positions, *, impl: str = "chunked",
              rope_theta: float = 10000.0, chunk: int = 1024):
    """Attention over the whole sequence; returns ``(out, k, v)``.

    ``k`` and ``v`` are the rotated keys and values (B,S,Hkv,D), which the
    prefill writes to the cache, so it computes them once per layer.
    """
    q, k, v = gqa_project_qkv(params, x, positions, rope_theta)
    if impl == "full":
        o = attend_full(q, k, v)
    elif impl == "chunked":
        o = attend_chunked(q, k, v, chunk=chunk)
    elif impl == "kernel":
        o = ops.flash_attention(q, k, v, causal=True)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    return gqa_output(params, o), k, v


def gqa_decode_layer(params, x, cache_k, cache_v, position, kv_len,
                     rope_theta: float = 10000.0):
    """Single-token decode through the flash-decode kernel.

    Writes the new K/V row into ``cache_k``/``cache_v`` **in place** (the
    JAX package returns new caches) and returns ``(out, cache_k,
    cache_v)`` with the same tensors.
    """
    q, k, v = _project(params, x)
    if cache_k.shape[2] != k.shape[2]:
        raise ValueError(f"a cache of {cache_k.shape[2]} KV heads for a "
                         f"layer that computes {k.shape[2]}")
    pos = position[:, None] if position.dim() == 1 else position
    q = apply_rope(q, pos, rope_theta)
    k = apply_rope(k, pos, rope_theta)
    _scatter_kv(cache_k, k, kv_len)
    _scatter_kv(cache_v, v, kv_len)
    o = ops.flash_decode(q, cache_k, cache_v, kv_len + 1)
    return gqa_output(params, o), cache_k, cache_v


def _scatter_kv(cache, new, kv_len):
    """Write (B,1,...) ``new`` at row ``kv_len[b]`` of (B,T,...) ``cache``
    (a K/V cache (B,T,N,D), or MLA's latent (B,T,R)), in place.

    A row with ``kv_len >= T`` is not written (``mode="drop"`` in the JAX
    package): its index is clamped and the old value written back, so the
    update needs no host sync.
    """
    b, t = cache.shape[0], cache.shape[1]
    rows = torch.arange(b, device=cache.device)
    idx = kv_len.long().clamp(max=t - 1)
    keep = (kv_len >= t).view(b, *(1,) * (cache.dim() - 2))
    cache[rows, idx] = torch.where(keep, cache[rows, idx],
                                   new[:, 0].to(cache.dtype))
