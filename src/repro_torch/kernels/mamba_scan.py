"""Chunked Mamba2 SSD on the card: the wrapper of ``csrc/mamba_scan.cu``.

Replaces ``repro/kernels/mamba_scan.py::mamba_scan``, and also returns the
final state, which the TPU kernel drops.  The plain version is
``ref.ssd_ref``; ``ops.mamba_scan`` picks between them by device.  The
kernel's own order of work and rounding, on the CPU, is ``ref.ssd_plan``.

One call is one device kernel: a block a (batch row, 64-row chunk, head,
slice of P), the state carried between chunks by a look-back through a
scratch (see the source).  The scratch comes from ``torch.empty`` at every
call; the counter and flags that order the blocks are kept per grid size
and device, and every launch leaves them at 0, so a CUDA graph may replay
the call.  Calls with one grid size on two streams at once would share
them.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0        # kernel launches since the last ops.reset_launch_counts()

ROWS = 64           # the kernel's chunk, whatever chunk the caller names
MAX_STATE = 128     # N; the tiles hold 64 or 128
ALIGN = 16          # bytes: rows on 16 bytes are copied 16 bytes at a time
_ENTRY = {torch.float32: "mamba_scan_f32", torch.bfloat16: "mamba_scan_bf16"}
_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
         + [ctypes.c_void_p, ctypes.c_void_p])
_counters = {}      # (device, units) -> int32 unit counter, done, flags


def tiling(b: int, s: int, h: int, p: int, sms: int):
    """(columns of P a block takes, blocks): 64 columns, or 32 where a grid
    of 64-column blocks would not give every SM two."""
    nc = -(-s // ROWS)
    pw = 64 if p > 32 and nc * b * h * -(-p // 64) >= 2 * sms else 32
    return pw, nc * b * h * -(-p // pw)


def state_tile(n: int) -> int:
    """The rows of N the tiles hold."""
    return 64 if n <= 64 else 128


def smem_bytes(dtype: torch.dtype, n: int, pw: int) -> int:
    """Shared memory of one block for x, B and C in ``dtype``, state width
    ``n`` and ``pw`` columns of P, as the kernel's source lays it out."""
    fn = _build.function("mamba_scan_smem", [ctypes.c_int] * 3)
    return fn(int(dtype == torch.bfloat16), n, pw)


def check_layout(xh: torch.Tensor, bm: torch.Tensor,
                 cm: torch.Tensor) -> None:
    """Raise ValueError on a width or layout the kernel refuses: N over
    128, P not a multiple of 4, or a last dimension of x, B or C that is
    not contiguous.  Works on tensors of any device, so the CPU tests reach
    it."""
    n, p = bm.shape[-1], xh.shape[-1]
    if n > MAX_STATE:
        raise ValueError(f"state width N={n} is over the kernel's "
                         f"{MAX_STATE}")
    if p % 4:
        raise ValueError(f"head width P={p} is not a multiple of 4")
    for name, t in (("x", xh), ("B", bm), ("C", cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dimension must be contiguous")


def rows_aligned(*tensors: torch.Tensor) -> bool:
    """Every row starts on 16 bytes (base address and outer strides), so
    the kernel copies rows with cp.async; else element by element."""
    return all(t.data_ptr() % ALIGN == 0
               and all(st * t.element_size() % ALIGN == 0
                       for st in t.stride()[:-1]) for t in tensors)


def _counters_for(dev, units: int) -> torch.Tensor:
    key = (dev, units)
    if key not in _counters:
        _counters[key] = torch.zeros(units + 2, dtype=torch.int32, device=dev)
    return _counters[key]


def mamba_scan(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
               bm: torch.Tensor, cm: torch.Tensor, *, chunk: int):
    """xh:(B,S,H,P) dt:(B,S,H) a_log:(H,) bm/cm:(B,S,N), CUDA ->
    (y (B,S,H,P) in xh's dtype, final state (B,H,N,P) fp32).

    ``chunk`` is the caller's chunk length and must divide S, as the TPU
    kernel's contract says; the kernel computes the same function in its
    own 64-row chunks.  xh, bm and cm may be strided views (the model's
    slices of one conv output) within ``check_layout``'s rules; dt and
    a_log go to the kernel in fp32.
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
    check_layout(xh, bm, cm)
    y = torch.empty((b, s, h, p), dtype=xh.dtype, device=dev)
    state = torch.empty((b, h, n, p), dtype=torch.float32, device=dev)
    if b * s * h * p == 0:
        return y, state.zero_()
    dt32 = dt.to(torch.float32).contiguous()
    a32 = a_log.to(torch.float32).contiguous()
    pw, units = tiling(b, s, h, p, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    ws = ctr = None                 # one chunk reads neither
    if s > ROWS:
        ws = torch.empty(2 * units * state_tile(n) * pw + units,
                         dtype=torch.float32, device=dev)
        ctr = _counters_for(dev, units)
    strides = (ctypes.c_longlong * 7)(*xh.stride()[:3], *bm.stride()[:2],
                                      *cm.stride()[:2])
    fn = _build.function(_ENTRY[xh.dtype], _ARGS)
    with torch.cuda.device(dev):
        err = fn(xh.data_ptr(), dt32.data_ptr(), a32.data_ptr(),
                 bm.data_ptr(), cm.data_ptr(), y.data_ptr(), state.data_ptr(),
                 None if ws is None else ws.data_ptr(),
                 None if ctr is None else ctr.data_ptr(), b, s, h, p, n, pw,
                 int(rows_aligned(xh, bm, cm)),
                 strides, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "mamba_scan")
    launches += 1
    return y, state
