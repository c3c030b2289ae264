"""Mamba2 (SSD) mixer, after ``repro/models/ssm.py``: the chunked SSD for
a whole sequence and the O(1) recurrent step for decode.

Chunked SSD (Dao & Gu 2024): split the sequence into chunks of length L;
within a chunk the state-space kernel is a lower-triangular (L, L) decay
matrix; across chunks a loop carries the (H, N, P) state.  B/C are
group-shared (G=1), so C·Bᵀ is computed once for all heads.

``ssd_chunked`` is the plain chunked path; the model's own path is
``ops.mamba_scan``, the chunked-SSD kernel on the card and its sequential
plain version on the CPU, which also returns the final state.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..kernels import ops
from .common import ParamSpec, rmsnorm


def mamba_spec(d_model: int, *, expand: int = 2, headdim: int = 64,
               state: int = 64, conv_width: int = 4) -> Dict[str, ParamSpec]:
    d_inner = expand * d_model
    h = d_inner // headdim
    conv_dim = d_inner + 2 * state                      # x, B, C get conv'd
    return {
        "in_proj": ParamSpec((d_model, 2 * d_inner + 2 * state + h),
                             ("embed", "mlp")),
        "conv_w": ParamSpec((conv_width, conv_dim), (None, "mlp")),
        "conv_b": ParamSpec((conv_dim,), ("mlp",), init="zeros"),
        "A_log": ParamSpec((h,), (None,), init="zeros"),
        "D": ParamSpec((h,), (None,), init="ones"),
        "dt_bias": ParamSpec((h,), (None,), init="zeros"),
        "norm": ParamSpec((d_inner,), ("mlp",), init="ones"),
        "out_proj": ParamSpec((d_inner, d_model), ("mlp", "embed")),
    }


def _mamba_dims(params):
    """(d_inner, heads, headdim, state) from the parameter shapes:
    proj = 2*d_inner + 2*state + h and conv_dim = d_inner + 2*state."""
    proj = params["in_proj"].shape[1]
    h = params["A_log"].shape[0]
    conv_dim = params["conv_w"].shape[1]
    d_inner = proj - conv_dim - h
    state = (conv_dim - d_inner) // 2
    return d_inner, h, d_inner // h, state


def causal_conv(x, w, b, init_state=None):
    """Depthwise causal conv. x:(B,S,C), w:(W,C). Returns (y, tail_state)."""
    width = w.shape[0]
    if init_state is None:
        init_state = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([init_state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
            for i in range(width))
    return y + b[None, None, :], xp[:, xp.shape[1] - (width - 1):, :]


def _segsum(da):
    """Lower-triangular pairwise sums: out[..., t, s] = sum_{s<r<=t} da_r."""
    l = da.shape[-1]
    cs = torch.cumsum(da, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(l, l, dtype=torch.bool, device=da.device).tril()
    return out.masked_fill(~mask, -torch.inf)


def ssd_chunked(xh, dt, a_log, bm, cm, *, chunk: int = 128,
                init_state=None):
    """Chunked SSD. xh:(B,S,H,P) dt:(B,S,H) bm/cm:(B,S,N) (group-shared).

    Returns (y:(B,S,H,P), final_state:(B,H,N,P)).
    """
    b, s, h, p = xh.shape
    n = bm.shape[-1]
    l = min(chunk, s)
    if s % l:
        raise ValueError(f"seq {s} not divisible by chunk {l}")
    nc = s // l
    a = -torch.exp(a_log.float())                      # (H,) negative
    dt32 = dt.float()
    da = dt32 * a[None, None, :]                       # (B,S,H)

    xc = xh.float().reshape(b, nc, l, h, p)
    dtc = dt32.reshape(b, nc, l, h)
    dac = da.reshape(b, nc, l, h)
    bc = bm.float().reshape(b, nc, l, n)
    cc = cm.float().reshape(b, nc, l, n)

    # --- intra-chunk (quadratic in l, head-shared C·B^T) ---
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)       # (B,nc,L,L)
    decay = torch.exp(_segsum(dac.movedim(-1, 2)))     # (B,nc,H,L,L)
    scores = cb[:, :, None] * decay                    # (B,nc,H,L,L)
    y_intra = torch.einsum("bchij,bcjh,bcjhp->bcihp", scores, dtc, xc)

    # --- chunk summaries -> inter-chunk loop ---
    cum = torch.cumsum(dac, dim=2)                     # (B,nc,L,H)
    rem = cum[:, :, -1:, :] - cum                      # decay to chunk end
    sc = torch.einsum("bcjn,bcjh,bcjhp->bchnp",
                      bc, dtc * torch.exp(rem), xc)    # (B,nc,H,N,P)
    total = torch.exp(cum[:, :, -1, :])                # (B,nc,H)

    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=xh.device) \
        if init_state is None else init_state.float()
    prevs = []
    for c in range(nc):
        prevs.append(state)
        state = state * total[:, c, :, None, None] + sc[:, c]
    prevs = torch.stack(prevs, dim=1)                  # (B,nc,H,N,P)

    y_inter = torch.einsum("bcin,bchnp,bcih->bcihp",
                           cc, prevs, torch.exp(cum))
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y.to(xh.dtype), state


def ssd_step(state, xh, dt, a_log, bm, cm):
    """Recurrent single-token step. state:(B,H,N,P) xh:(B,H,P) dt:(B,H)."""
    a = -torch.exp(a_log.float())
    da = dt.float() * a[None, :]                       # (B,H)
    decay = torch.exp(da)[..., None, None]
    upd = torch.einsum("bn,bh,bhp->bhnp", bm.float(), dt.float(), xh.float())
    new_state = state * decay + upd
    y = torch.einsum("bn,bhnp->bhp", cm.float(), new_state)
    return new_state, y.to(xh.dtype)


# ---------------------------------------------------------------------------
# Full mixer layer
# ---------------------------------------------------------------------------


def _project(params, x):
    d_inner, h, headdim, state = _mamba_dims(params)
    zxbcdt = torch.einsum("bsd,dk->bsk", x, params["in_proj"])
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * state, h], -1)
    return z, xbc, dt, (d_inner, h, headdim, state)


def _gate_out(params, y, xh, z, plain: bool = False):
    """Skip term, gated RMSNorm (through the RMSNorm kernel on the card, or
    plain on the plain route) and the output projection."""
    b, s = y.shape[0], y.shape[1]
    y = y + params["D"][None, None, :, None].to(y.dtype) * xh
    y = rmsnorm({"scale": params["norm"]}, y.reshape(b, s, -1) * F.silu(z),
                plain=plain)
    return torch.einsum("bsk,kd->bsd", y, params["out_proj"])


def mamba_mixer(params, x, *, chunk: int = 128, impl: str = "chunked"):
    """Mamba2 mixer over a whole sequence, whose length must be a multiple
    of min(chunk, S).  Returns ``(out, {"conv", "ssm"})``: the conv tail and
    the final SSD state, which a prefill keeps as the layer's decode cache.

    ``impl``: "kernel" runs ``ops.mamba_scan`` (the kernel on the card, its
    plain version on the CPU), "chunked" runs ``ssd_chunked``, and
    "plain", the training forward's route, runs ``ssd_chunked`` and the
    plain gated norm, as the JAX package trains.
    """
    b, s, _ = x.shape
    z, xbc, dt, (d_inner, h, headdim, state) = _project(params, x)
    xbc, conv_tail = causal_conv(xbc, params["conv_w"], params["conv_b"])
    xbc = F.silu(xbc)
    xh, bm, cm = torch.split(xbc, [d_inner, state, state], -1)
    xh = xh.reshape(b, s, h, headdim)
    dt = F.softplus(dt + params["dt_bias"][None, None, :])
    if impl == "kernel":
        y, ssm = ops.mamba_scan(xh, dt, params["A_log"], bm, cm, chunk=chunk)
    elif impl in ("chunked", "plain"):
        y, ssm = ssd_chunked(xh, dt, params["A_log"], bm, cm, chunk=chunk)
    else:
        raise ValueError(f"unknown SSD impl {impl!r}")
    return _gate_out(params, y, xh, z, impl == "plain"), {"conv": conv_tail,
                                                          "ssm": ssm}


def mamba_layer(params, x, *, chunk: int = 128, impl: str = "chunked"):
    """Train/prefill Mamba2 mixer over a full sequence.

    Sequences not divisible by the chunk are zero-padded at the END
    (causal: pad positions cannot affect real outputs) and trimmed.
    """
    s0 = x.shape[1]
    pad = (-s0) % min(chunk, s0) if s0 else 0
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    out, _ = mamba_mixer(params, x, chunk=chunk, impl=impl)
    return out[:, :s0]


def mamba_init_cache(params, batch: int, dtype=torch.float32):
    d_inner, h, headdim, state = _mamba_dims(params)
    width, conv_dim = params["conv_w"].shape
    dev = params["conv_w"].device
    return {
        "conv": torch.zeros((batch, width - 1, conv_dim), dtype=dtype,
                            device=dev),
        "ssm": torch.zeros((batch, h, state, headdim), dtype=torch.float32,
                           device=dev),
    }


def mamba_decode_layer(params, x, cache):
    """Single-token step. x:(B,1,D); cache {'conv','ssm'}.

    Returns ``(out, {"conv", "ssm"})`` with new state tensors; the caller
    writes them into its cache.
    """
    b = x.shape[0]
    z, xbc, dt, (d_inner, h, headdim, state) = _project(params, x)
    xbc, conv_state = causal_conv(xbc, params["conv_w"], params["conv_b"],
                                  init_state=cache["conv"])
    xbc = F.silu(xbc)
    xh, bm, cm = torch.split(xbc[:, 0], [d_inner, state, state], -1)
    xh = xh.reshape(b, h, headdim)
    dt = F.softplus(dt[:, 0] + params["dt_bias"][None, :])
    new_ssm, y = ssd_step(cache["ssm"], xh, dt, params["A_log"], bm, cm)
    return _gate_out(params, y[:, None], xh[:, None], z), \
        {"conv": conv_state, "ssm": new_ssm}
