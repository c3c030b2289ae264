"""Chunked Mamba2 SSD on the card: the wrapper of ``csrc/mamba_scan.cu``.

Replaces ``repro/kernels/mamba_scan.py::mamba_scan``, and also returns the
final state, which the TPU kernel drops.  The plain version is
``ref.ssd_ref``; ``ops.mamba_scan`` picks between them by device.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0        # kernel launches since the last ops.reset_launch_counts()

_ENTRY = {torch.float32: "mamba_scan_f32", torch.bfloat16: "mamba_scan_bf16"}
_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
         + [ctypes.c_void_p, ctypes.c_void_p])
MAX_SMEM_BYTES = 232_448     # the shared memory one Hopper block can have


def smem_bytes(chunk: int, n: int, p: int) -> int:
    """The kernel's fp32 tiles: X (L,P), B and C (L,N+1), the state (N,P),
    the masked scores (L,L+1) and three length-L vectors."""
    return 4 * (chunk * p + 2 * chunk * (n + 1) + n * p + chunk * (chunk + 1)
                + 3 * chunk)


def mamba_scan(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
               bm: torch.Tensor, cm: torch.Tensor, *, chunk: int):
    """xh:(B,S,H,P) dt:(B,S,H) a_log:(H,) bm/cm:(B,S,N), CUDA ->
    (y (B,S,H,P) in xh's dtype, final state (B,H,N,P) fp32).

    ``chunk`` is the chunk length L and must divide S.  xh, bm and cm may
    be strided views (the model's slices of one conv output) as long as
    their last dimension is contiguous; dt and a = -exp(a_log) go to the
    kernel in fp32.
    """
    global launches
    _build.refuse_grad("mamba_scan", xh, dt, a_log, bm, cm)
    b, s, h, p = xh.shape
    n = bm.shape[-1]
    dev = xh.device
    if not (dev.type == "cuda" and all(t.device == dev
                                       for t in (dt, a_log, bm, cm))):
        raise ValueError("mamba_scan kernel takes CUDA tensors on one device")
    if xh.dtype not in _ENTRY or bm.dtype != xh.dtype or cm.dtype != xh.dtype:
        raise TypeError(f"mamba_scan kernel takes x, B and C in one of "
                        f"float32/bfloat16, got {xh.dtype}, {bm.dtype}, "
                        f"{cm.dtype}")
    if dt.shape != (b, s, h) or a_log.shape != (h,) \
            or bm.shape != (b, s, n) or cm.shape != (b, s, n):
        raise ValueError(f"shapes x{tuple(xh.shape)} dt{tuple(dt.shape)} "
                         f"a_log{tuple(a_log.shape)} B{tuple(bm.shape)} "
                         f"C{tuple(cm.shape)} do not form an SSD scan")
    if chunk <= 0 or s % chunk:
        raise ValueError(f"chunk {chunk} does not divide S={s}")
    if xh.stride(-1) != 1 or bm.stride(-1) != 1 or cm.stride(-1) != 1:
        raise ValueError("the last dimension of x, B and C must be "
                         "contiguous")
    if smem_bytes(chunk, n, p) > MAX_SMEM_BYTES:
        raise ValueError(f"chunk {chunk} with N={n}, P={p} needs "
                         f"{smem_bytes(chunk, n, p)} bytes of shared memory, "
                         f"over the {MAX_SMEM_BYTES} a block can have")
    dt32 = dt.to(torch.float32).contiguous()
    a = (-torch.exp(a_log.to(torch.float32))).contiguous()
    y = torch.empty((b, s, h, p), dtype=xh.dtype, device=dev)
    state = torch.empty((b, h, n, p), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 7)(*xh.stride()[:3], *bm.stride()[:2],
                                      *cm.stride()[:2])
    fn = _build.function(_ENTRY[xh.dtype], _ARGS)
    with torch.cuda.device(dev):
        err = fn(xh.data_ptr(), dt32.data_ptr(), a.data_ptr(), bm.data_ptr(),
                 cm.data_ptr(), y.data_ptr(), state.data_ptr(), b, s, h, p, n,
                 chunk, strides, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "mamba_scan")
    launches += 1
    return y, state
