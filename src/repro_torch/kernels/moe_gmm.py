"""Grouped (per-expert) matmul on the card: the wrapper of
``csrc/moe_gmm.cu``.

Replaces ``repro/kernels/moe_gmm.py::gmm``.  The plain version is
``ref.gmm_ref``; ``ops.moe_gmm`` picks between them by device.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

launches = 0        # kernel launches since the last ops.reset_launch_counts()

_ENTRY = {torch.float32: "moe_gmm_f32", torch.bfloat16: "moe_gmm_bf16"}
_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
         + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
_PATH_ARGS = ([ctypes.c_int] * 3 + [ctypes.c_longlong] * 2
              + [ctypes.c_void_p] * 2 + [ctypes.c_int])
PATHS = ("stream", "tiled")


def path(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel's path for these operands, as its C launcher picks it:
    ``"stream"`` (the GEMV, C <= 8, or a layout TMA cannot read) or
    ``"tiled"`` (TMA and tensor cores)."""
    fn = _build.function("moe_gmm_path", _PATH_ARGS)
    return PATHS[fn(x.shape[1], x.shape[2], w.shape[-1], x.stride(0),
                    x.stride(1), x.data_ptr(), w.data_ptr(),
                    x.element_size())]


def moe_gmm(x: torch.Tensor, w: torch.Tensor,
            rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x:(E,C,D) w:(E,D,F) CUDA tensors -> (E,C,F) in x's dtype.

    ``rows``, an (E,) int32 tensor on x's device, counts the rows each
    expert holds: row r of expert e is x[e, r] @ w[e] for
    r < min(rows[e], C) and exactly 0 past it, and an expert with no rows
    reads no weights.  ``None`` means all C rows.  Any C is taken (the
    kernel masks a ragged C tile).  The E experts need not be a model's
    first: under expert parallelism they are one device's block, experts
    [i E, (i + 1) E) of the model's, and ``rows`` is that block's slice of
    the counts.  x may be a strided view as long as its last dimension is
    contiguous; w must be contiguous.
    """
    global launches
    _build.refuse_grad("moe_gmm", x, w)
    if not (x.device.type == "cuda" and w.device == x.device):
        raise ValueError("moe_gmm kernel takes CUDA tensors on one device")
    if x.dtype not in _ENTRY or w.dtype != x.dtype:
        raise TypeError(f"moe_gmm kernel takes x and w in one of "
                        f"float32/bfloat16, got {x.dtype}, {w.dtype}")
    if x.dim() != 3 or w.dim() != 3 or w.shape[:2] != (x.shape[0],
                                                       x.shape[2]):
        raise ValueError(f"shapes x{tuple(x.shape)} w{tuple(w.shape)} do "
                         f"not form a grouped matmul (E,C,D) @ (E,D,F)")
    if x.stride(-1) != 1 and x.shape[-1] > 1:
        raise ValueError("the last dimension of x must be contiguous")
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")
    e, c, d = x.shape
    f = w.shape[-1]
    if rows is not None and not (
            rows.device == x.device and rows.dtype == torch.int32
            and tuple(rows.shape) == (e,) and rows.is_contiguous()):
        raise ValueError(f"rows must be a contiguous ({e},) int32 tensor on "
                         f"{x.device}, got {tuple(rows.shape)} {rows.dtype} "
                         f"on {rows.device}")
    y = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    fn = _build.function(_ENTRY[x.dtype], _ARGS)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                 None if rows is None else rows.data_ptr(), e, c, d, f,
                 x.stride(0), x.stride(1),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "moe_gmm")
    launches += 1
    return y
