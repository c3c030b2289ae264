"""RMSNorm on the card: the wrapper of ``csrc/rmsnorm.cu``.

Replaces ``repro/kernels/rmsnorm.py::rmsnorm``.  The plain version is
``ref.rmsnorm_ref``; ``ops.fused_rmsnorm`` picks between them by device.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0        # kernel launches since the last ops.reset_launch_counts()

_ENTRY = {torch.float32: "rmsnorm_f32", torch.bfloat16: "rmsnorm_bf16"}
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_float, ctypes.c_void_p]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """(N,D),(D,) CUDA tensors -> (N,D) in x's dtype; fp32 math."""
    global launches
    _build.refuse_grad("rmsnorm", x, scale)
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError("rmsnorm kernel takes CUDA tensors on one device")
    if x.dtype not in _ENTRY:
        raise TypeError(f"rmsnorm kernel takes float32/bfloat16, "
                        f"not {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"rmsnorm kernel takes a contiguous (N, D) tensor, "
                         f"got shape {tuple(x.shape)}")
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
