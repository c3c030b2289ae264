"""Flash decode on the card: the wrapper of ``csrc/flash_decode.cu``.

Replaces ``repro/kernels/flash_decode.py::flash_decode``.  The plain
version is ``ref.decode_ref``; ``ops.flash_decode`` picks between them by
device and changes the layout.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0        # kernel launches since the last ops.reset_launch_counts()

_ENTRY = {torch.float32: "flash_decode_f32",
          torch.bfloat16: "flash_decode_bf16"}
_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
         + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
MAX_HEAD_DIM = 256


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor, *, scale=None) -> torch.Tensor:
    """q:(B,H,D) k/v:(B,Hkv,T,D) kv_len:(B,) int32, CUDA -> (B,H,Dv).

    ``kv_len`` stays on the device: the kernel reads it, so the call needs
    no host sync.  Strides as in ``flash_attention_fwd``: the model's
    (B,T,Hkv,D) cache passes as its transposed view.
    """
    global launches
    _build.refuse_grad("flash_decode", q, k, v, kv_len)
    b, h, d = q.shape
    hkv, t, dv = k.shape[1], k.shape[2], v.shape[-1]
    dev = q.device
    if not (dev.type == "cuda" and k.device == dev and v.device == dev
            and kv_len.device == dev):
        raise ValueError("flash decode kernel takes CUDA tensors on one "
                         "device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _ENTRY:
        raise TypeError(f"flash decode kernel takes one of float32/"
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if kv_len.dtype != torch.int32 or kv_len.shape != (b,) \
            or not kv_len.is_contiguous():
        raise ValueError("kv_len must be a contiguous (B,) int32 tensor")
    if k.shape != (b, hkv, t, d) or v.shape[:3] != (b, hkv, t) \
            or hkv == 0 or h % hkv:
        raise ValueError(f"shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} do not form GQA decode")
    if max(d, dv) > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}/{dv} over {MAX_HEAD_DIM}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the head dimension must be contiguous")
    scale = d ** -0.5 if scale is None else float(scale)
    out = torch.empty((b, h, dv), dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 10)(*q.stride()[:2], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:2])
    fn = _build.function(_ENTRY[q.dtype], _ARGS)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                 out.data_ptr(), b, h, hkv, t, d, dv, strides, scale,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_decode")
    launches += 1
    return out
