"""sLSTM recurrence on the card: the wrapper of ``csrc/slstm_seq.cu``.

Replaces ``repro/kernels/slstm_cell.py::slstm_seq``.  Unlike the TPU
kernel it takes any S >= 1, starts from an optional state and returns the
final one.  The plain version is ``ref.slstm_seq_ref``; ``ops.slstm_seq``
picks between them by device.

A launch is a thread-block cluster per (head, group of up to
``MAX_ROWS`` batch rows); each block of a cluster keeps its columns of the
recurrent matrix in registers and the cluster trades h through distributed
shared memory, one cluster barrier a step (see the source).
:func:`cluster_plan` lays the launch out from the shapes alone.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from . import _build

launches = 0        # kernel launches since the last ops.reset_launch_counts()

_ENTRY = {torch.float32: "slstm_seq_f32", torch.bfloat16: "slstm_seq_bf16"}
_ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
MAX_HEAD_DIM = 256       # the kernel's lanes reach 256 values of h
MAX_CLUSTER = 16         # Hopper's largest cluster (non-portable above 8)
MAX_ROWS = 4             # batch rows a cluster serves with one copy of R
MAX_THREADS = 256        # the kernel's launch bound, 8 a column
STATE_KEYS = ("c", "n", "h", "m")


class Plan(NamedTuple):
    cluster: int                # K, blocks a cluster
    cols: Tuple[int, ...]       # columns each block owns, block by block
    rows: int                   # batch rows a cluster serves
    grid: Tuple[int, int, int]  # (K, heads, groups of rows)
    threads: int                # a block's: 8 a column of the widest
    smem: int                   # a block's shared memory, bytes


def cluster_plan(b: int, h: int, dh: int, dtype: torch.dtype) -> Plan:
    """The launch of ``b`` batch rows, ``h`` heads and head dim ``dh``:
    a cluster of ``MAX_CLUSTER`` blocks (fewer where Dh has fewer 4-column
    groups), Dh's 4-column groups dealt to its blocks as evenly as they
    go, and up to ``MAX_ROWS`` rows a cluster, the rows spread evenly over
    the fewest clusters.  ``smem`` is what the kernel lays out: two fp32 h
    buffers of 1 or ``MAX_ROWS`` row slots, each as wide as the lanes reach
    (64, 192 or 256)."""
    if dtype not in _ENTRY:
        raise TypeError(f"slstm_seq kernel takes xg in float32/bfloat16, got "
                        f"{dtype}")
    if dh % 4 or not 4 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"slstm_seq kernel takes a head dim that is a "
                         f"multiple of 4 up to {MAX_HEAD_DIM}, got Dh={dh}")
    k = min(MAX_CLUSTER, dh // 4)
    base, extra = divmod(dh // 4, k)
    cols = tuple(4 * (base + (i < extra)) for i in range(k))
    groups = -(-b // MAX_ROWS)
    rows = -(-b // groups) if groups else 1
    span = 64 if dh <= 64 else 192 if dh <= 192 else 256
    slots = 1 if rows <= 1 else MAX_ROWS
    return Plan(k, cols, rows, (k, h, groups), 8 * max(cols),
                4 * 2 * slots * span)


def slstm_seq(xg: torch.Tensor, r: torch.Tensor, bias: torch.Tensor,
              state=None):
    """xg:(B,S,4,H,Dh) f32/bf16, r:(4,H,Dh,Dh), bias:(4,H,Dh), ``state`` an
    optional {"c","n","h","m"} of (B,H,Dh) fp32, all CUDA -> (h (B,S,H,Dh)
    in xg's dtype, final state {"c","n","h","m"} (B,H,Dh) fp32).

    r and bias go to the kernel in fp32, as the TPU kernel upcasts them;
    xg and the state leaves must be contiguous.  The launch is laid out by
    :func:`cluster_plan`.
    """
    global launches
    _build.refuse_grad("slstm_seq", xg, r, bias,
                       *(() if state is None else state.values()))
    if xg.dim() != 5 or xg.shape[2] != 4:
        raise ValueError(f"xg of shape {tuple(xg.shape)} is not "
                         f"(B, S, 4, H, Dh)")
    b, s, _, h, dh = xg.shape
    dev = xg.device
    leaves = [] if state is None else [state[k] for k in STATE_KEYS]
    if not (dev.type == "cuda" and all(t.device == dev
                                       for t in (r, bias, *leaves))):
        raise ValueError("slstm_seq kernel takes CUDA tensors on one device")
    if xg.dtype not in _ENTRY:
        raise TypeError(f"slstm_seq kernel takes xg in float32/bfloat16, got "
                        f"{xg.dtype}")
    if r.shape != (4, h, dh, dh) or bias.shape != (4, h, dh):
        raise ValueError(f"shapes xg{tuple(xg.shape)} r{tuple(r.shape)} "
                         f"bias{tuple(bias.shape)} do not form an sLSTM")
    if s < 1 or dh % 4 or not 4 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"slstm_seq kernel takes S >= 1 and a head dim "
                         f"that is a multiple of 4 up to {MAX_HEAD_DIM}, got "
                         f"S={s}, Dh={dh}")
    if not xg.is_contiguous():
        raise ValueError("slstm_seq kernel takes a contiguous xg")
    for t in leaves:
        if t.shape != (b, h, dh) or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"an sLSTM state leaf must be a contiguous "
                             f"(B, H, Dh) = {(b, h, dh)} fp32 tensor, got "
                             f"{tuple(t.shape)} {t.dtype}")
    r32 = r.to(torch.float32).contiguous()
    b32 = bias.to(torch.float32).contiguous()
    if r32.data_ptr() % 16:
        raise ValueError("slstm_seq kernel reads r in 16-byte vectors: r "
                         "must be 16-byte aligned")
    plan = cluster_plan(b, h, dh, xg.dtype)
    out = torch.empty((b, s, h, dh), dtype=xg.dtype, device=dev)
    final = {k: torch.empty((b, h, dh), dtype=torch.float32, device=dev)
             for k in STATE_KEYS}
    init = [t.data_ptr() for t in leaves] if leaves else [None] * 4
    fn = _build.function(_ENTRY[xg.dtype], _ARGS)
    with torch.cuda.device(dev):
        err = fn(xg.data_ptr(), r32.data_ptr(), b32.data_ptr(), *init,
                 out.data_ptr(), *(final[k].data_ptr() for k in STATE_KEYS),
                 b, s, h, dh, plan.cluster, plan.rows,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "slstm_seq")
    launches += 1
    return out, final
