"""RMSNorm on the card: the wrappers of ``csrc/rmsnorm.cu``.

Replaces ``repro/kernels/rmsnorm.py::rmsnorm``.  The plain version is
``ref.rmsnorm_ref``; ``ops.fused_rmsnorm`` picks between them by device.
A norm whose width is split over devices (Mamba2's gated norm under
tensor parallelism) takes two entries: :func:`sumsq`, each row's fp32
sum of squares, and :func:`scaled`, the rows normalised by a total given
(the sums all-reduced between the two); their plain versions are
``ref.rmsnorm_sumsq_ref`` and ``ref.rmsnorm_scaled_ref``, and
``ops.rmsnorm_sumsq`` / ``ops.rmsnorm_scaled`` pick by device.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# kernel launches since the last ops.reset_launch_counts(), an entry each
launches = 0
sumsq_launches = 0
scaled_launches = 0

_ENTRY = {torch.float32: "rmsnorm_f32", torch.bfloat16: "rmsnorm_bf16"}
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_float, ctypes.c_void_p]


def _rows(name: str, x: torch.Tensor, *others: torch.Tensor) -> None:
    """Raise unless ``x`` is a contiguous (N, D) float32/bfloat16 CUDA
    tensor and ``others`` lie on its device."""
    _build.refuse_grad(name, x, *others)
    if x.device.type != "cuda" or any(t.device != x.device for t in others):
        raise ValueError(f"{name} kernel takes CUDA tensors on one device")
    if x.dtype not in _ENTRY:
        raise TypeError(f"{name} kernel takes float32/bfloat16, "
                        f"not {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name} kernel takes a contiguous (N, D) tensor, "
                         f"got shape {tuple(x.shape)}")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """(N,D),(D,) CUDA tensors -> (N,D) in x's dtype; fp32 math."""
    global launches
    _rows("rmsnorm", x, scale)
    n, d = x.shape
    if scale.shape != (d,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({d},)")
    s = scale.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    fn = _build.function(_ENTRY[x.dtype], _ARGS)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), s.data_ptr(), y.data_ptr(), n, d, eps,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "rmsnorm")
    launches += 1
    return y


_SUMSQ = {torch.float32: "rmsnorm_sumsq_f32",
          torch.bfloat16: "rmsnorm_sumsq_bf16"}
_SUMSQ_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p]
_SCALED = {torch.float32: "rmsnorm_scaled_f32",
           torch.bfloat16: "rmsnorm_scaled_bf16"}
_SCALED_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_float, ctypes.c_void_p]


def sumsq(x: torch.Tensor) -> torch.Tensor:
    """(N,W) CUDA tensor -> (N,) fp32 sums of the squares of each row."""
    global sumsq_launches
    _rows("rmsnorm_sumsq", x)
    n, w = x.shape
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    fn = _build.function(_SUMSQ[x.dtype], _SUMSQ_ARGS)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), n, w,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "rmsnorm_sumsq")
    sumsq_launches += 1
    return out


def scaled(x: torch.Tensor, total: torch.Tensor, scale: torch.Tensor,
           width: int, eps: float = 1e-5) -> torch.Tensor:
    """(N,W) x, (N,) fp32 ``total``, (W,) scale, CUDA tensors -> (N,W) in
    x's dtype: x * rsqrt(total / width + eps) * scale, fp32 math."""
    global scaled_launches
    _rows("rmsnorm_scaled", x, total, scale)
    n, w = x.shape
    if total.shape != (n,) or scale.shape != (w,):
        raise ValueError(f"total {tuple(total.shape)} and scale "
                         f"{tuple(scale.shape)} for rows {(n, w)}")
    t = total.to(torch.float32).contiguous()
    s = scale.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    fn = _build.function(_SCALED[x.dtype], _SCALED_ARGS)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), t.data_ptr(), s.data_ptr(), y.data_ptr(), n,
                 w, float(width), eps,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "rmsnorm_scaled")
    scaled_launches += 1
    return y
