"""Flash attention forward on the card: the wrapper of
``csrc/flash_attention.cu`` (TMA loads; wgmma in bf16, 3xTF32 mma.sync in
fp32).

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
# widest q/k row: deepseek_v2_236b's MLA prefill, qk_nope 128 + qk_rope 64
MAX_HEAD_DIM = 192
# widest v row: the output accumulator's 64 registers a thread
MAX_VALUE_DIM = 128
# head dims the tensor-core products step through: wgmma's k16 in bf16,
# mma.sync's k8 in fp32
HEAD_DIM_MULTIPLE = {torch.bfloat16: 16, torch.float32: 8}
TMA_ALIGN = 16      # bytes: TMA's base address and stride granule
SMEM_LIMIT = 232448     # bytes of shared memory a block may have on sm_90


def stages(dtype: torch.dtype, d: int) -> int:
    """Ring stages of K and V tiles: 4 in bf16, 3 in fp32 up to D 128 and 2
    above (three fp32 stages at D 192 would need 295,992 bytes)."""
    return 4 if dtype == torch.bfloat16 else (3 if d <= 128 else 2)


def smem_bytes(dtype: torch.dtype, d: int, dv: int) -> int:
    """Dynamic shared memory of one CTA, as the kernel's launch sizes it:
    1 KB of alignment slack, the Q block and the :func:`stages` of K and V
    in boxes of 64 rows by 128 bytes (wgmma's N covers whole V boxes in
    bf16), and two mbarriers a stage and one for Q."""
    bf16 = dtype == torch.bfloat16
    box, n = (64 if bf16 else 32), stages(dtype, d)
    nbd = -(-d // box)
    nbv = (64 if dv <= 64 else 128) // 64 if bf16 else -(-dv // 32)
    return 1024 + (nbd + n * (nbd + nbv)) * 64 * 128 + 8 * (2 * n + 1)


def plan(dtype: torch.dtype, d: int, dv: int) -> int:
    """The kernel's host plan for head widths ``d`` (q, k) and ``dv`` (v):
    raises ValueError on widths it refuses (multiples of 16 in bf16 and of
    8 in fp32, d at most 192, dv at most 128) and returns the bytes of
    shared memory a CTA takes.  Shapes only, so the dry run's fake tensors
    reach it."""
    if dtype not in HEAD_DIM_MULTIPLE:
        raise TypeError(f"flash attention kernel takes one of float32/"
                        f"bfloat16, got {dtype}")
    mult = HEAD_DIM_MULTIPLE[dtype]
    for name, w, cap in (("q/k", d, MAX_HEAD_DIM), ("v", dv, MAX_VALUE_DIM)):
        if w <= 0 or w > cap or w % mult:
            raise ValueError(f"{name}: head dim {w} must be a multiple of "
                             f"{mult} in {dtype}, at most {cap}")
    smem = smem_bytes(dtype, d, dv)
    if smem > SMEM_LIMIT:
        raise ValueError(f"D={d}, Dv={dv} in {dtype} need {smem} bytes of "
                         f"shared memory a block, over {SMEM_LIMIT}")
    return smem


def tma_strides(x: torch.Tensor) -> tuple:
    """The three outer strides of a (B, H, S, D) tensor as its tensor map
    takes them.  A dimension of size 1 is never stepped, so its stride is
    replaced by one row's length rounded up to the TMA granule."""
    el = x.element_size()
    row = -(-x.shape[-1] * el // TMA_ALIGN) * TMA_ALIGN // el
    return tuple(st if n > 1 else row
                 for n, st in zip(x.shape[:3], x.stride()[:3]))


def check_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ValueError on a head width or layout the kernel refuses.

    The widths as :func:`plan` takes them; the head dimension contiguous;
    each base pointer 16-byte aligned and each outer stride a multiple of
    16 bytes, as TMA requires.  Works on tensors of any device, so the CPU
    tests reach it.
    """
    for d in {q.shape[-1], k.shape[-1]}:
        plan(q.dtype, d, v.shape[-1])
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name}: the head dimension must be contiguous")
        if x.data_ptr() % TMA_ALIGN:
            raise ValueError(f"{name}: base address not {TMA_ALIGN}-byte "
                             f"aligned, as TMA needs (storage offset "
                             f"{x.storage_offset()})")
        if any(st * x.element_size() % TMA_ALIGN for st in tma_strides(x)):
            raise ValueError(f"{name}: strides {x.stride()} are not multiples "
                             f"of {TMA_ALIGN} bytes, as TMA needs")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, scale=None) -> torch.Tensor:
    """q:(B,H,S,D) k/v:(B,Hkv,T,D) CUDA tensors -> (B,H,S,Dv).

    Any strides are taken within ``check_layout``'s rules, so a (B,S,H,D)
    tensor passes as its transposed view without a copy; the result is a
    (B,H,S,Dv) view of a contiguous (B,S,H,Dv) tensor.
    """
    global launches
    _build.refuse_grad("flash_attention", q, k, v)
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
    check_layout(q, k, v)
    scale = d ** -0.5 if scale is None else float(scale)
    out = torch.empty((b, s, h, dv), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*tma_strides(q), *tma_strides(k),
                                       *tma_strides(v), *out.stride()[:3])
    fn = _build.function(_ENTRY[q.dtype], _ARGS)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, h, hkv, s, t, d, dv, strides, scale, int(causal),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_attention")
    launches += 1
    return out
