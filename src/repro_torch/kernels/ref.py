"""Plain PyTorch versions of the port's kernels (the allclose targets).

Ported from ``repro/kernels/ref.py``: quadratic attention, masked softmax
decode, fp32 RMSNorm, the sequential SSD recurrence, the grouped matmul
and the sequential sLSTM recurrence, independent of the model code so a
kernel bug cannot hide behind a shared helper.  On the CPU the kernel
wrappers in ``ops`` run these; on the card ``chip_smoke.py`` holds each
kernel against them.
"""
from __future__ import annotations

import torch

from ..analysis import hlo

NEG_INF = -1e30


def _repeat_kv(k, h):
    hkv = k.shape[1]
    return k if hkv == h else k.repeat_interleave(h // hkv, dim=1)


def attention_ref(q, k, v, *, causal: bool = True, scale=None):
    """q:(B,H,S,D) k/v:(B,Hkv,T,D) -> (B,H,S,Dv); GQA by head repeat.

    Causal masking aligns bottom-right (``tril(., t - s)``), as the JAX
    oracle does; the kernel aligns top-left, so the two agree at S == T.
    """
    b, h, s, d = q.shape
    t = k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    k = _repeat_kv(k, h).float()
    v = _repeat_kv(v, h).float()
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k) * scale
    if causal:
        mask = torch.ones(s, t, dtype=torch.bool, device=q.device).tril(t - s)
        logits = logits.masked_fill(~mask, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", w, v).to(q.dtype)


def tf32(x):
    """fp32 rounded to TF32 by its bits: to nearest, ties away from zero
    (13 mantissa bits dropped), as ``cvt.rna.tf32.f32`` does; finite x."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _product_3xtf32(eq, a, b):
    """einsum of fp32 operands as three TF32 products in fp32:
    lo(a)·hi(b) + hi(a)·lo(b) + hi(a)·hi(b), with hi = tf32(x) and
    lo = tf32(x - hi)."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def _product_tf32(eq, a, b):
    """einsum of fp32 operands as one TF32 product."""
    return torch.einsum(eq, tf32(a), tf32(b))


def _attention_plan(q, k, v, causal, scale, qk, pv, round_p):
    """Softmax attention with the kernel's order of work: scores by ``qk``,
    p = exp(s - max) unnormalised, l = sum of fp32 p, ``round_p`` applied
    to p before ``pv``, then a division by max(l, 1e-30)."""
    b, h, s, d = q.shape
    t = k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    k = _repeat_kv(k, h).float()
    v = _repeat_kv(v, h).float()
    logits = qk("bhsd,bhtd->bhst", q.float(), k) * scale
    if causal:
        mask = torch.ones(s, t, dtype=torch.bool, device=q.device).tril(t - s)
        logits = logits.masked_fill(~mask, NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    out = pv("bhst,bhtd->bhsd", round_p(p), v) / l.clamp(min=1e-30)
    return out.to(q.dtype)


def attention_3xtf32(q, k, v, *, causal: bool = True, scale=None,
                     split: bool = True):
    """The fp32 CUDA kernel's rounding plan: both products on TF32 tensor
    cores as three products (``split=False``: one TF32 product, which the
    fp32 gate does not pass).  Layout as ``attention_ref``; for tests."""
    prod = _product_3xtf32 if split else _product_tf32
    return _attention_plan(q, k, v, causal, scale, prod, prod, lambda p: p)


def attention_bf16p(q, k, v, *, causal: bool = True, scale=None):
    """The bf16 CUDA kernel's rounding plan: fp32 scores of the bf16 inputs,
    p rounded to bf16 before P·V (the row sum l from fp32 p).  Layout as
    ``attention_ref``; for tests."""
    return _attention_plan(q, k, v, causal, scale, torch.einsum,
                           torch.einsum,
                           lambda p: p.to(torch.bfloat16).float())


def decode_ref(q, k, v, kv_len=None, scale=None):
    """q:(B,H,D) k/v:(B,Hkv,T,D) kv_len:(B,) -> (B,H,Dv).

    With kv_len = 0 this gives the mean of V (softmax over all-masked
    logits); the kernel gives 0.  The serving path never asks for 0.
    """
    b, h, d = q.shape
    t = k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    k = _repeat_kv(k, h).float()
    v = _repeat_kv(v, h).float()
    logits = torch.einsum("bhd,bhtd->bht", q.float(), k) * scale
    if kv_len is not None:
        mask = torch.arange(t, device=q.device)[None, None, :] < \
            kv_len.to(q.device)[:, None, None]
        logits = logits.masked_fill(~mask, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bht,bhtd->bhd", w, v).to(q.dtype)


def decode_split_ref(q, k, v, kv_len, split: int, scale=None, tile: int = 32,
                     round_p: bool = False):
    """The CUDA decode kernel's plan: the key axis cut into ``split``
    chunks (T / split rounded up to the ``tile``), a partial (m, l, acc) per
    chunk over the keys below kv_len, then the max-shifted merge, in which a
    chunk with no key weighs exactly 0.  fp32 throughout; with ``round_p``
    P is rounded to bf16 before P·V (l stays the fp32 sum), as the kernel's
    tensor-core path does (``flash_decode.rounds_p``: a bf16 block of 8-16
    heads, at the plan's heads a block, 16 at the widest rows).  The value
    may be a view of the key's rows, as MLA's latent decode hands it.
    Keys at or past kv_len enter no product, so the cache's unwritten tail
    may hold anything, NaN included.  Layout as ``decode_ref``; kv_len = 0
    gives 0, as the kernel does."""
    b, h, d = q.shape
    t = k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    k = _repeat_kv(k, h).float()
    v = _repeat_kv(v, h).float()
    logits = torch.einsum("bhd,bhtd->bht", q.float(), k) * scale
    valid = torch.arange(t, device=q.device)[None, None, :] < \
        kv_len.to(q.device)[:, None, None]
    per = -(-t // split)
    chunk = -(-per // tile) * tile
    ms, has, ls, accs = [], [], [], []
    for s0 in range(0, split * chunk, chunk):
        live = valid[..., s0:s0 + chunk]
        x = logits[..., s0:s0 + chunk].masked_fill(~live, NEG_INF)
        m = torch.cat([x, x.new_full((b, h, 1), NEG_INF)], -1).amax(-1)
        p = torch.exp(x - m[..., None]).masked_fill(~live, 0.0)
        ms.append(m)
        has.append(live.any(dim=-1))
        ls.append(p.sum(dim=-1))
        vc = v[:, :, s0:s0 + chunk].masked_fill(~live[..., None], 0.0)
        pv = p.to(torch.bfloat16).float() if round_p else p
        accs.append(torch.einsum("bht,bhtd->bhd", pv, vc))
    m = torch.stack(ms)                               # (split, B, H)
    w = torch.where(torch.stack(has), torch.exp(m - m.amax(dim=0)), 0.0)
    l = (w * torch.stack(ls)).sum(dim=0)
    acc = (w[..., None] * torch.stack(accs)).sum(dim=0)
    return (acc / l.clamp(min=1e-30)[..., None]).to(q.dtype)


def rmsnorm_ref(x, scale, eps: float = 1e-5):
    """(N,D),(D,) -> (N,D), fp32 math."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def gmm_ref(x, w, rows=None):
    """Grouped matmul oracle: (E,C,D) @ (E,D,F) -> (E,C,F), fp32 math, the
    result in x's dtype.  With ``rows`` (E,), row r of expert e is exactly 0
    from min(rows[e], C) on, whatever x holds there."""
    out = torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
    if rows is None:
        return out
    past = torch.arange(x.shape[1], device=x.device)[None, :] >= rows[:, None]
    return out.masked_fill(past[..., None], 0)


def ssd_ref(xh, dt, a_log, bm, cm):
    """Sequential-recurrence oracle of the chunked SSD kernel.

    xh:(B,S,H,P) dt:(B,S,H) a_log:(H,) bm/cm:(B,S,N) -> y (B,S,H,P) in
    xh's dtype and the final state (B,H,N,P) in fp32, by the direct
    h_t = exp(dt*A) h_{t-1} + dt*B x recurrence with fp32 math.
    """
    b, s, h, p = xh.shape
    n = bm.shape[-1]
    a = -torch.exp(a_log.float())
    x32, dt32, b32, c32 = xh.float(), dt.float(), bm.float(), cm.float()
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=xh.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt32[:, t] * a[None, :])[..., None, None]
        upd = torch.einsum("bn,bh,bhp->bhnp", b32[:, t], dt32[:, t],
                           x32[:, t])
        state = state * decay + upd
        ys.append(torch.einsum("bn,bhnp->bhp", c32[:, t], state))
    return torch.stack(ys, dim=1).to(xh.dtype), state


def ssd_plan(xh, dt, a_log, bm, cm, *, rows: int = 64):
    """The CUDA SSD kernel's plan: its chunks and its rounding.

    The sequence is cut into chunks of ``rows`` (the last one ragged).  Per
    chunk, with cum the cumsum of dt * a and w = dt exp(cum_L - cum):
    Z = (B ⊙ w)ᵀ X, G = (C Bᵀ) ⊙ exp(cum_i - cum_j) ⊙ dt_j for j <= i,
    y = G X + exp(cum) ⊙ (C state), then state = exp(cum_L) state + Z.
    fp32 x, B and C: every product in 3xTF32.  bf16: C Bᵀ, G X and Z in
    fp32 over bf16 operands, with G and B ⊙ w each cut to a bf16 pair hi +
    lo first (hi = bf16(v), lo = bf16(v - hi)); C state in 3xTF32, which for
    bf16 C (exact in TF32) is two products.  The state is fp32 throughout.
    Layout and results as ``ssd_ref``; for tests.
    """
    b, s, h, p = xh.shape
    n = bm.shape[-1]
    a = -torch.exp(a_log.float())
    if xh.dtype == torch.bfloat16:
        prod = torch.einsum

        def rnd(t):
            hi = t.to(torch.bfloat16).float()
            return hi + (t - hi).to(torch.bfloat16).float()
    else:
        prod = _product_3xtf32

        def rnd(t):
            return t
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=xh.device)
    ys = []
    for c0 in range(0, s, rows):
        x = xh[:, c0:c0 + rows].float()                    # (B,L,H,P)
        d = dt[:, c0:c0 + rows].float()                    # (B,L,H)
        bc, cc = bm[:, c0:c0 + rows].float(), cm[:, c0:c0 + rows].float()
        ell = x.shape[1]
        cum = torch.cumsum(d * a, dim=1)                   # (B,L,H)
        last = cum[:, -1]                                  # (B,H)
        w = d * torch.exp(last[:, None] - cum)
        z = prod("bjhn,bjhp->bhnp", rnd(bc[:, :, None] * w[..., None]), x)
        tri = torch.ones(ell, ell, dtype=torch.bool, device=xh.device).tril()
        decay = torch.where(tri[None, :, :, None],
                            torch.exp(cum[:, :, None] - cum[:, None]), 0.0)
        cb = prod("bin,bjn->bij", cc, bc)                  # (B,L,L)
        g = rnd(cb[..., None] * decay * d[:, None])        # (B,i,j,H)
        y = prod("bijh,bjhp->bihp", g, x) + torch.exp(cum)[..., None] * \
            _product_3xtf32("bin,bhnp->bihp", cc, state)
        state = torch.exp(last)[..., None, None] * state + z
        ys.append(y)
    return torch.cat(ys, dim=1).to(xh.dtype), state


def slstm_seq_ref(xg, r, bias, state=None):
    """Sequential sLSTM oracle, step by step in fp32.

    xg:(B,S,4,H,Dh) precomputed input gates (z, i, f, o); r:(4,H,Dh,Dh)
    block-diagonal recurrent weights; bias:(4,H,Dh); ``state`` an optional
    {"c","n","h","m"} of (B,H,Dh) to start from, zeros (m too) without
    one.  Returns (h (B,S,H,Dh) in xg's dtype, the final state, each leaf
    (B,H,Dh) fp32).  The forget gate is taken in log space and the input
    gate is exponential, both stabilised by the running max m.
    """
    b, s, _, h, dh = xg.shape
    if state is None:
        state = {k: torch.zeros((b, h, dh), dtype=torch.float32,
                                device=xg.device) for k in "cnhm"}
    c, n, hp, m = (state[k].float() for k in "cnhm")
    r32, b32 = r.float(), bias.float()[None]
    hs = []
    with hlo.recurrence(s):         # the op counter's recurrent buffers
        for t in range(s):
            g = xg[:, t].float() + torch.einsum("bhd,ghde->bghe", hp,
                                                r32) + b32
            zt = torch.tanh(g[:, 0])
            it = g[:, 1]
            ft = torch.nn.functional.logsigmoid(g[:, 2])
            ot = torch.sigmoid(g[:, 3])
            m_new = torch.maximum(ft + m, it)
            i_ = torch.exp(it - m_new)
            f_ = torch.exp(ft + m - m_new)
            c = f_ * c + i_ * zt
            n = f_ * n + i_
            hp = ot * c / torch.clamp(n, min=1.0)
            m = m_new
            hs.append(hp)
    out = torch.stack(hs, dim=1) if hs else xg.new_zeros((b, 0, h, dh))
    return out.to(xg.dtype), {"c": c, "n": n, "h": hp, "m": m}
