"""Flash attention forward on the card: the wrapper of
``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention.py::flash_attention_fwd``.  The
plain version is ``ref.attention_ref``; ``ops.flash_attention`` picks
between them by device and changes the layout.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0        # kernel launches since the last ops.reset_launch_counts()

_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
         + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
MAX_HEAD_DIM = 128


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, scale=None) -> torch.Tensor:
    """q:(B,H,S,D) k/v:(B,Hkv,T,D) CUDA tensors -> (B,H,S,Dv).

    Any strides are taken as long as the head dimension is contiguous, so
    a (B,S,H,D) tensor passes as its transposed view without a copy; the
    result is a (B,H,S,Dv) view of a contiguous (B,S,H,Dv) tensor.
    """
    global launches
    b, h, s, d = q.shape
    hkv, t, dv = k.shape[1], k.shape[2], v.shape[-1]
    if not (q.device.type == "cuda" and k.device == q.device
            and v.device == q.device):
        raise ValueError("flash attention kernel takes CUDA tensors on one "
                         "device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _ENTRY:
        raise TypeError(f"flash attention kernel takes one of float32/"
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != (b, hkv, t, d) or v.shape[:3] != (b, hkv, t) \
            or hkv == 0 or h % hkv:
        raise ValueError(f"shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} do not form GQA attention")
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}/{dv} over {MAX_HEAD_DIM}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the head dimension must be contiguous")
    scale = d ** -0.5 if scale is None else float(scale)
    out = torch.empty((b, s, h, dv), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    fn = _build.function(_ENTRY[q.dtype], _ARGS)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, h, hkv, s, t, d, dv, strides, scale, int(causal),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_attention")
    launches += 1
    return out
