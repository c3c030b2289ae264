"""Public wrappers over the port's kernels, mirroring ``repro/kernels/ops.py``.

Each op takes the model zoo's (B,S,H,D) layout and hands the kernel the
(B,H,S,D) view of it (a stride change, no copy).  The device of the
inputs picks the implementation, and nothing else does:

* CUDA tensors go to the hand-written kernel; a failed build or launch
  raises, it never falls back;
* CPU tensors go to the plain PyTorch version in ``ref`` (the CPU tests'
  path);
* any other device raises.

Both paths check the TPU kernels' block contracts (S == T when causal,
mamba_scan's chunk, moe_gmm's 128-wide blocks), so the two packages
accept the same shapes there.  Head widths are the CUDA kernels' own:
``flash_attention.plan`` and ``flash_decode.plan`` (at most 192 / 128 and
576 / 512, within a block's shared memory) run before each launch and on
the traced route below, so a configuration the card would refuse fails
in the dry run too; the plain route takes any width, as the TPU kernels
do.

Under the op counter (``analysis.hlo``) each call counts as one kernel
call by the formula of its row in ``chip_smoke.py``'s bound column, from
shapes alone (the full cache for a decode, every row of every expert for
the grouped matmul), and the ops inside it are not counted.  Fake tensors
(the dry run's) take the card's route, with the plain version in the
kernel's place (for the SSD scan and the sLSTM, whose plain versions loop
over the sequence, empty outputs of the kernel's shapes) and nothing
launched, so a traced step and the card's count the same.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor

from ..analysis import hlo
from . import flash_attention as _fa
from . import flash_decode as _fd
from . import mamba_scan as _ms
from . import moe_gmm as _gmm
from . import ref
from . import rmsnorm as _rms
from . import slstm_cell as _sl

# each kernel entry's launch count: (its wrapper module, the counter)
_KERNELS = {"flash_attention": (_fa, "launches"),
            "flash_decode": (_fd, "launches"),
            "mamba_scan": (_ms, "launches"), "moe_gmm": (_gmm, "launches"),
            "rmsnorm": (_rms, "launches"),
            "rmsnorm_sumsq": (_rms, "sumsq_launches"),
            "rmsnorm_scaled": (_rms, "scaled_launches"),
            "slstm_seq": (_sl, "launches")}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel entry since the last reset."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _KERNELS.values():
        setattr(mod, attr, 0)


def _fake(*tensors: torch.Tensor) -> bool:
    return any(isinstance(t, FakeTensor) for t in tensors)


def _route(*tensors: torch.Tensor) -> str:
    """"kernel" for CUDA tensors, "plain" for CPU ones, and "traced" for
    fake tensors: the card's route with the plain version in the kernel's
    place."""
    if _fake(*tensors):
        return "traced"
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return "plain"
    if kinds == {"cuda"}:
        return "kernel"
    raise ValueError(f"tensors on {sorted(kinds)}: the kernels run on CUDA "
                     f"and their plain versions on the CPU")


def _attention_fwd(q, k, v, causal, scale):
    """(B,H,S,D) views: the kernel, or on fake tensors its plain version
    after the kernel's host plan."""
    if _fake(q, k, v):
        _fa.plan(q.dtype, q.shape[-1], v.shape[-1])
        return ref.attention_ref(q, k, v, causal=causal, scale=scale)
    return _fa.flash_attention_fwd(q, k, v, causal=causal, scale=scale)


def _attention_cost(q, k, v, causal):
    """(flops, bytes) of (B,S,H,D) attention: 2 (D + Dv) a (query, key)
    pair, the causal triangle's pairs; q, k, v read and the output written
    once."""
    b, s, h, d = q.shape
    t, dv = k.shape[1], v.shape[-1]
    pairs = b * h * s * (s + 1) // 2 if causal else b * h * s * t
    nbytes = (q.numel() + b * s * h * dv + k.numel() + v.numel()) \
        * q.element_size()
    return 2 * (d + dv) * pairs, nbytes


class _FlashAttention(torch.autograd.Function):
    """The kernel's forward with the oracle's backward: the counterpart of
    the JAX package's custom VJP ``_flash_attn_core``, whose backward rule
    differentiates ``ref.attention_ref`` at the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        with torch.no_grad():
            return _attention_fwd(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (x.detach().requires_grad_() for x in ctx.saved_tensors)
        with torch.enable_grad():
            out = ref.attention_ref(q, k, v, causal=ctx.causal,
                                    scale=ctx.scale)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, scale=None):
    """q:(B,S,H,D) k/v:(B,T,Hkv,D) -> (B,S,H,Dv).

    Any S and T: the CUDA kernel masks its ragged last tiles (the TPU
    kernel's 128-row blocks are a VMEM blocking detail, which JAX's
    ``attend_chunked`` pads around).  Causal attention needs S == T, where
    the kernel's top-left and the oracle's bottom-right alignment agree.

    On the card the result carries a ``grad_fn`` when an input requires
    grad: the backward differentiates the oracle, as the JAX package's
    custom VJP does.
    """
    s, t = q.shape[1], k.shape[1]
    if causal and s != t:
        raise ValueError(f"causal flash attention needs S == T, got "
                         f"S={s}, T={t}")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    with hlo.kernel("flash_attention",
                    lambda: _attention_cost(q, k, v, causal)):
        if _route(q, k, v) == "plain":
            out = ref.attention_ref(qt, kt, vt, causal=causal, scale=scale)
        elif torch.is_grad_enabled() and any(
                x.requires_grad for x in (q, k, v)):
            out = _FlashAttention.apply(qt, kt, vt, causal, scale)
        else:
            out = _attention_fwd(qt, kt, vt, causal, scale)
    return out.transpose(1, 2)


def flash_decode(q, k, v, kv_len, *, scale=None):
    """q:(B,1,H,D) k/v:(B,T,Hkv,D) kv_len:(B,) int32 -> (B,1,H,Dv).

    Any cache length T: the CUDA kernel runs a partial last tile (the TPU
    kernel's 256-key blocks are a VMEM blocking detail).
    """
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)

    def cost():
        b, _, h, d = q.shape
        t, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
        nbytes = (q.numel() + b * h * dv + hkv * (d + dv) * b * t) \
            * q.element_size() + 4 * b
        return 2 * (d + dv) * h * b * t, nbytes

    with hlo.kernel("flash_decode", cost):
        route = _route(q, k, v, kv_len)
        if route == "kernel":
            out = _fd.flash_decode(q[:, 0], kt, vt, kv_len, scale=scale)
        else:
            if route == "traced":
                _fd.plan(q.dtype, q.shape[-1], v.shape[-1],
                         q.shape[2] // k.shape[2], _fd.value_in_key(kt, vt))
            out = ref.decode_ref(q[:, 0], kt, vt, kv_len, scale=scale)
    return out[:, None]


def mamba_scan(xh, dt, a_log, bm, cm, *, chunk: int = 128):
    """Chunked SSD: xh:(B,S,H,P) dt:(B,S,H) a_log:(H,) bm/cm:(B,S,N) ->
    (y (B,S,H,P), final state (B,H,N,P) fp32).

    Block contract of the TPU ``mamba_scan`` and of ``ssd_chunked``: the
    chunk is min(chunk, S), and S must be a multiple of it.
    """
    s = xh.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"mamba_scan takes S a multiple of its chunk, got "
                         f"S={s}, chunk={chunk}")

    def cost():
        b, _, h, p = xh.shape
        n, el = bm.shape[-1], xh.element_size()
        nc, pairs = s // chunk, chunk * (chunk + 1) // 2
        nbytes = el * (2 * xh.numel() + 2 * b * s * n + dt.numel()) \
            + 4 * h + 4 * b * h * n * p
        return (b * nc * (2 * n * pairs + h * (2 * p * pairs
                                               + 4 * chunk * n * p)),
                nbytes)

    with hlo.kernel("mamba_scan", cost):
        route = _route(xh, dt, a_log, bm, cm)
        if route == "kernel":
            return _ms.mamba_scan(xh, dt, a_log, bm, cm, chunk=chunk)
        if route == "traced":       # the oracle is a loop over S
            b, _, h, p = xh.shape
            return xh.new_empty(xh.shape), xh.new_empty(
                (b, h, bm.shape[-1], p), dtype=torch.float32)
        return ref.ssd_ref(xh, dt, a_log, bm, cm)


def moe_gmm(x, w, rows=None):
    """Grouped matmul (E,C,D) @ (E,D,F) -> (E,C,F), fp32 accumulation, the
    result in x's dtype.

    ``rows``: an optional (E,) int32 tensor of the rows each expert holds.
    Row r of expert e is then x[e, r] @ w[e] for r < min(rows[e], C) and
    exactly 0 past it, whatever x holds there; on the rows the TPU ``gmm``
    combines that is its result.  The kernel reads no weights of an expert
    without rows.  x and w may be a block of a model's experts whose
    first is not expert 0 (expert parallelism: E is E/m, the experts of
    one device) with ``rows`` that block's slice of the counts.

    Block contract of the TPU ``gmm``: D a multiple of min(128, D) and F of
    min(128, F).  Any C is taken: the TPU wrapper pads C to its block, the
    CUDA kernel masks it.
    """
    d, f = x.shape[-1], w.shape[-1]
    if d % min(128, d) or f % min(128, f):
        raise ValueError(f"moe_gmm takes D and F that are multiples of their "
                         f"128-wide block, got D={d}, F={f}")
    if rows is not None and (rows.dtype != torch.int32
                             or tuple(rows.shape) != (x.shape[0],)):
        raise ValueError(f"moe_gmm takes rows as an ({x.shape[0]},) int32 "
                         f"tensor, got {tuple(rows.shape)} {rows.dtype}")

    def cost():
        e, c = x.shape[0], x.shape[1]
        nbytes = (e * c * d + e * d * f + e * c * f) * x.element_size() \
            + (0 if rows is None else 4 * e)
        return 2 * e * c * d * f, nbytes

    ins = (x, w, *(() if rows is None else (rows,)))
    with hlo.kernel("moe_gmm", cost):
        if _route(*ins) == "kernel":
            return _gmm.moe_gmm(x, w, rows)
        return ref.gmm_ref(x, w, rows)


def slstm_seq(xg, r, bias, state=None):
    """sLSTM recurrence: xg:(B,S,4,H,Dh) r:(4,H,Dh,Dh) bias:(4,H,Dh), an
    optional initial state {"c","n","h","m"} of (B,H,Dh) fp32 (zeros
    without one) -> (h (B,S,H,Dh) in xg's dtype, final state, fp32).

    Any S >= 1 is taken: the TPU wrapper's S % min(256, S) == 0 is a VMEM
    blocking detail, and the JAX model's recurrence takes any length.
    """
    if xg.dim() != 5 or xg.shape[1] < 1:
        raise ValueError(f"slstm_seq takes xg (B, S, 4, H, Dh) with S >= 1, "
                         f"got {tuple(xg.shape)}")
    leaves = [] if state is None else [state[k] for k in _sl.STATE_KEYS]

    def cost():
        b, s, _, h, dh = xg.shape
        n_state = 4 * 4 * b * h * dh * (1 if state is None else 2)
        nbytes = xg.element_size() * (xg.numel() + b * s * h * dh) \
            + 4 * (r.numel() + bias.numel()) + n_state
        return 2 * b * s * 4 * h * dh * dh, nbytes

    with hlo.kernel("slstm_seq", cost):
        route = _route(xg, r, bias, *leaves)
        if route == "kernel":
            return _sl.slstm_seq(xg, r, bias, state)
        if route == "traced":       # the oracle is a loop over S
            b, s, _, h, dh = xg.shape
            return xg.new_empty((b, s, h, dh)), {
                k: xg.new_empty((b, h, dh), dtype=torch.float32)
                for k in _sl.STATE_KEYS}
        return ref.slstm_seq_ref(xg, r, bias, state)


def fused_rmsnorm(x, scale, *, eps: float = 1e-5):
    """RMSNorm over the last axis of any (..., D) tensor, fp32 math."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    cost = lambda: (4 * x.numel(),
                    2 * x.numel() * x.element_size() + 4 * shape[-1])
    with hlo.kernel("rmsnorm", cost):
        if _route(x, scale) == "kernel":
            out = _rms.rmsnorm(x2.contiguous(), scale, eps)
        else:
            out = ref.rmsnorm_ref(x2, scale, eps)
    return out.reshape(shape)


def rmsnorm_sumsq(x):
    """(..., W) -> (...) fp32 sums of squares over the last axis (an
    RMSNorm's first half where its width is split over devices)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    cost = lambda: (2 * x.numel(), x.numel() * x.element_size()
                    + 4 * x2.shape[0])
    with hlo.kernel("rmsnorm_sumsq", cost):
        if _route(x) == "kernel":
            out = _rms.sumsq(x2.contiguous())
        else:
            out = ref.rmsnorm_sumsq_ref(x2)
    return out.reshape(shape[:-1])


def rmsnorm_scaled(x, total, scale, width: int, *, eps: float = 1e-5):
    """(..., W) x normalised by its rows' sums of squares ``total`` (...,
    fp32) over ``width`` channels: x * rsqrt(total / width + eps) *
    scale, fp32 math, in x's dtype."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    t2 = total.reshape(-1)
    cost = lambda: (3 * x.numel(), 2 * x.numel() * x.element_size()
                    + 4 * (t2.numel() + shape[-1]))
    with hlo.kernel("rmsnorm_scaled", cost):
        if _route(x, total, scale) == "kernel":
            out = _rms.scaled(x2.contiguous(), t2, scale, width, eps)
        else:
            out = ref.rmsnorm_scaled_ref(x2, t2, scale, width, eps)
    return out.reshape(shape)
