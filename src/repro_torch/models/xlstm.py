"""xLSTM blocks, after ``repro/models/xlstm.py``: mLSTM (matrix memory,
parallel-trainable) and sLSTM (scalar memory, strict recurrence) — Beck et
al. 2024.

The mLSTM is plain tensor algebra, as in the JAX package: the parallel
(quadratic) form, the chunked form that carries the (Dh, Dh) matrix memory
across chunks and returns it as the decode cache, and the O(1) decode
step.  The sLSTM recurrence of a prefill and of a decode step goes
through ``ops.slstm_seq`` (the hand-written kernel on the card, its
sequential plain version on the CPU), which starts from the cache's state
and returns the final one; the JAX package runs it as a ``lax.scan`` of
``_slstm_cell``, which stays here as the plain one-step function.  On the
plain route (``plain=True``, the training forward) the sLSTM is the
kernel's plain version, the same step-by-step fp32 recurrence, and the
head norms are plain.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..kernels import ops, ref
from .common import ParamSpec, rmsnorm

NEG_INF = -1e30


def _head_norm(params, hid, plain: bool = False):
    """RMSNorm over all heads of (..., H, Dh) with the (H, Dh) scale."""
    shape = hid.shape
    return rmsnorm({"scale": params["norm"].reshape(-1)},
                   hid.reshape(*shape[:-2], -1), plain=plain).reshape(shape)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_spec(d_model: int, n_heads: int) -> Dict[str, ParamSpec]:
    dh = d_model // n_heads
    return {
        "wq": ParamSpec((d_model, n_heads, dh), ("embed", "heads", None)),
        "wk": ParamSpec((d_model, n_heads, dh), ("embed", "heads", None)),
        "wv": ParamSpec((d_model, n_heads, dh), ("embed", "heads", None)),
        "wi": ParamSpec((d_model, n_heads), ("embed", "heads"), scale=0.02),
        "wf": ParamSpec((d_model, n_heads), ("embed", "heads"), scale=0.02),
        "bi": ParamSpec((n_heads,), ("heads",), init="zeros"),
        "bf": ParamSpec((n_heads,), ("heads",), init="ones"),
        "wo": ParamSpec((n_heads, dh, d_model), ("heads", None, "embed")),
        "norm": ParamSpec((n_heads, dh), ("heads", None), init="ones"),
    }


def _mlstm_gates(params, x):
    i = torch.einsum("bsd,dh->bsh", x, params["wi"]) + params["bi"]
    f = torch.einsum("bsd,dh->bsh", x, params["wf"]) + params["bf"]
    return i.float(), F.logsigmoid(f.float())


def _qkv(params, x):
    """(B,S,D) -> q, k, v (B,H,S,Dh)."""
    return tuple(torch.einsum("bsd,dhk->bhsk", x, params[w])
                 for w in ("wq", "wk", "wv"))


def mlstm_parallel(params, x):
    """Parallel (quadratic) mLSTM over a sequence. x:(B,S,D)."""
    b, s, d = x.shape
    h = params["wi"].shape[1]
    dh = d // h
    q, k, v = _qkv(params, x)
    i, logf = _mlstm_gates(params, x)                  # (B,S,H)
    cumf = torch.cumsum(logf, dim=1)
    # D[t,s] = i_s + cumf_t - cumf_s  (s <= t)
    dmat = (i - cumf)[:, None, :, :] + cumf[:, :, None, :]   # (B,T,S,H)
    dmat = dmat.permute(0, 3, 1, 2)                    # (B,H,T,S)
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    dmat = dmat.masked_fill(~mask, NEG_INF)
    m = dmat.amax(dim=-1, keepdim=True)                # (B,H,T,1)
    scores = torch.einsum("bhtk,bhsk->bhts", q.float(), k.float()) \
        * (dh ** -0.5)
    a = scores * torch.exp(dmat - m)
    denom = torch.maximum(a.sum(-1, keepdim=True).abs(), torch.exp(-m))
    aw = (a / denom).to(v.dtype)
    hid = torch.einsum("bhts,bhsk->bhtk", aw.float(), v.float())
    hid = _head_norm(params, hid.transpose(1, 2))      # (B,S,H,Dh)
    return torch.einsum("bshk,hkd->bsd", hid.to(x.dtype), params["wo"])


def mlstm_init_cache(params, batch: int):
    h = params["wi"].shape[1]
    dh = params["wq"].shape[2]
    dev = params["wq"].device
    return {
        "C": torch.zeros((batch, h, dh, dh), dtype=torch.float32, device=dev),
        "n": torch.zeros((batch, h, dh), dtype=torch.float32, device=dev),
        # -1e30 = "empty": exp(m_prev - m_new) underflows to 0 so the empty
        # state contributes nothing (matches the parallel form).
        "m": torch.full((batch, h), NEG_INF, dtype=torch.float32,
                        device=dev),
    }


def mlstm_chunked(params, x, *, chunk: int = 1024, carry=None,
                  plain: bool = False):
    """Chunked mLSTM: quadratic only within L-token chunks, the (K,V)
    matrix memory carried across chunks.

    Returns (out (B,S,D), carry {C,n,m}) — the carry is the decode cache.
    S must be a multiple of L = min(chunk, S), as in the JAX package.
    """
    b, s, d = x.shape
    h = params["wi"].shape[1]
    dh = d // h
    l = min(chunk, s)
    if s % l:
        raise ValueError(f"mlstm_chunked takes S a multiple of its chunk, "
                         f"got S={s}, chunk={l}")
    nc = s // l
    q, k, v = _qkv(params, x)
    i, logf = _mlstm_gates(params, x)                  # (B,S,H) f32
    if carry is None:
        carry = mlstm_init_cache(params, b)
    c_s, n_s, m_s = carry["C"], carry["n"], carry["m"]
    scale = dh ** -0.5
    tri = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    hids = []
    for ci in range(nc):
        rows = slice(ci * l, (ci + 1) * l)
        qb, kb, vb = q[:, :, rows], k[:, :, rows], v[:, :, rows]
        qf, kf, vf = qb.float(), kb.float(), vb.float()
        ib = i[:, rows].transpose(1, 2)                # (B,H,L)
        fb = logf[:, rows].transpose(1, 2)
        cum = torch.cumsum(fb, dim=-1)
        # intra-chunk log weights D[t,s] = i_s + cum_t - cum_s
        dmat = ib[:, :, None, :] + cum[:, :, :, None] - cum[:, :, None, :]
        dmat = dmat.masked_fill(~tri, NEG_INF)
        # inter log weight of the carried state at step t
        w = cum + m_s[..., None]                       # (B,H,L)
        m_t = torch.maximum(dmat.amax(-1), w)
        intra = torch.exp(dmat - m_t[..., None])
        a = torch.einsum("bhtk,bhsk->bhts", qf, kf) * scale * intra
        wexp = torch.exp(w - m_t)
        num = torch.einsum("bhts,bhsv->bhtv", a.to(vb.dtype).float(), vf) \
            + wexp[..., None] * torch.einsum("bhtk,bhkv->bhtv", qf * scale,
                                             c_s)
        den = a.sum(-1) + wexp * torch.einsum("bhtk,bhk->bht", qf * scale,
                                              n_s)
        hids.append(num / torch.maximum(den.abs(),
                                        torch.exp(-m_t))[..., None])
        # carry update (telescoped decode recursion)
        tot = cum[..., -1]                             # (B,H)
        wk = ib + tot[..., None] - cum                 # per-key log weight
        m_new = torch.maximum(m_s + tot, wk.amax(-1))
        kw = torch.exp(wk - m_new[..., None])
        decay = torch.exp(m_s + tot - m_new)
        c_s = decay[..., None, None] * c_s + torch.einsum(
            "bhs,bhsk,bhsv->bhkv", kw, kf, vf)
        n_s = decay[..., None] * n_s + torch.einsum("bhs,bhsk->bhk", kw, kf)
        m_s = m_new
    hid = _head_norm(params, torch.cat(hids, dim=2).transpose(1, 2), plain)
    out = torch.einsum("bshk,hkd->bsd", hid.to(x.dtype), params["wo"])
    return out, {"C": c_s, "n": n_s, "m": m_s}


def mlstm_decode(params, x, cache):
    """O(1) recurrent step. x:(B,1,D) -> (out (B,1,D), new cache)."""
    b, _, d = x.shape
    h = params["wi"].shape[1]
    dh = d // h
    q, k, v = (torch.einsum("bd,dhk->bhk", x[:, 0], params[w]).float()
               for w in ("wq", "wk", "wv"))
    i, logf = _mlstm_gates(params, x[:, :1])
    i, logf = i[:, 0], logf[:, 0]                      # (B,H)
    m_new = torch.maximum(logf + cache["m"], i)
    decay = torch.exp(logf + cache["m"] - m_new)[..., None]
    inp = torch.exp(i - m_new)[..., None]
    c = cache["C"] * decay[..., None] \
        + inp[..., None] * k[..., :, None] * v[..., None, :]
    n = cache["n"] * decay + inp * k
    qs = q * (dh ** -0.5)
    num = torch.einsum("bhk,bhkv->bhv", qs, c)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", qs, n).abs(),
                        torch.exp(-m_new))
    hid = _head_norm(params, num / den[..., None])
    out = torch.einsum("bhk,hkd->bd", hid.to(x.dtype), params["wo"])
    return out[:, None], {"C": c, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_spec(d_model: int, n_heads: int) -> Dict[str, ParamSpec]:
    dh = d_model // n_heads
    return {
        # input weights for gates z, i, f, o
        "wx": ParamSpec((d_model, 4, n_heads, dh),
                        ("embed", None, "heads", None)),
        # block-diagonal recurrent weights per head
        "rh": ParamSpec((4, n_heads, dh, dh), (None, "heads", None, None),
                        scale=0.02),
        "b": ParamSpec((4, n_heads, dh), (None, "heads", None), init="zeros"),
        "norm": ParamSpec((n_heads, dh), ("heads", None), init="ones"),
        "wo": ParamSpec((n_heads, dh, d_model), ("heads", None, "embed")),
    }


def slstm_init_cache(params, batch: int):
    _, h, dh, _ = params["rh"].shape
    return {k: torch.zeros((batch, h, dh), dtype=torch.float32,
                           device=params["rh"].device)
            for k in ("c", "n", "h", "m")}


def _slstm_cell(params, state, xg):
    """One plain step. xg: (B,4,H,Dh) pre-computed input contribution."""
    c, n, hprev, m = state["c"], state["n"], state["h"], state["m"]
    rec = torch.einsum("bhd,ghde->bghe", hprev, params["rh"].float())
    g = xg.float() + rec + params["b"].float()[None]
    zt = torch.tanh(g[:, 0])
    it = g[:, 1]                                        # exp gate (log space)
    ft = F.logsigmoid(g[:, 2])                          # forget in log space
    ot = torch.sigmoid(g[:, 3])
    m_new = torch.maximum(ft + m, it)
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(ft + m - m_new)
    c_new = f_ * c + i_ * zt
    n_new = f_ * n + i_
    h_new = ot * c_new / torch.clamp(n_new, min=1.0)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def _gate_inputs(params, x):
    """x:(B,S,D) -> xg (B,S,4,H,Dh), contiguous, as the kernel takes it."""
    b, s, d = x.shape
    wx = params["wx"]
    return (x.reshape(b * s, d) @ wx.reshape(d, -1)).reshape(
        b, s, *wx.shape[1:])


def slstm_mixer(params, x, state=None, *, plain: bool = False):
    """The sLSTM over a sequence from ``state`` (zeros without one), through
    ``ops.slstm_seq``, or its plain version ``ref.slstm_seq_ref`` on the
    plain route, given fp32 gates so that h stays fp32 as in JAX's scan.
    x:(B,S,D) -> (out (B,S,D), final state)."""
    xg = _gate_inputs(params, x)
    if plain:
        hs, state = ref.slstm_seq_ref(xg.float(), params["rh"],
                                      params["b"], state)
    else:
        hs, state = ops.slstm_seq(xg, params["rh"], params["b"], state)
    hs = _head_norm(params, hs, plain)                  # (B,S,H,Dh)
    return torch.einsum("bshk,hkd->bsd", hs.to(x.dtype), params["wo"]), state


def slstm_layer(params, x):
    """Recurrent sLSTM over a sequence from a zero state. x:(B,S,D)."""
    return slstm_mixer(params, x)[0]


def slstm_decode(params, x, cache):
    """One step from the cache's state: the kernel at S = 1, whose one h is
    the final h. x:(B,1,D) -> (out (B,1,D), new state)."""
    return slstm_mixer(params, x, cache)
