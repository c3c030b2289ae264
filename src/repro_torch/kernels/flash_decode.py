"""Flash decode on the card: the wrapper of ``csrc/flash_decode.cu``.

Replaces ``repro/kernels/flash_decode.py::flash_decode``.  The plain
version is ``ref.decode_ref``; ``ops.flash_decode`` picks between them by
device and changes the layout.  The kernel splits the key axis over a
grid of blocks and merges the splits in the same launch, through a small
scratch that the wrapper allocates once per shape; ``ref.decode_split_ref``
is that plan in plain PyTorch.  The split count comes from
:func:`split_count`, which reads the shapes and the SM count and never
``kv_len``, so a call is one launch with no host sync, and a CUDA graph
can capture it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0        # kernel launches since the last ops.reset_launch_counts()

_ENTRY = {torch.float32: "flash_decode_f32",
          torch.bfloat16: "flash_decode_bf16"}
_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
         + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p])
# widest rows: a key of MLA's latent decode (minicpm3_4b's kv_lora 256 +
# qk_rope 32) and a value of 256, which fit the fp32 block's shared memory
MAX_KEY_DIM = 288
MAX_VALUE_DIM = 256
MAX_SPLIT = 32          # key splits of a group
MIN_SPLIT_KEYS = 32     # keys a split keeps at least: one tile
MAX_BLOCK_HEADS = 32    # query heads a block serves; larger groups take more
_sm_count = {}
_scratch = {}           # (device, shape) -> (fp32 partials, int32 counters)


def split_count(t: int, groups: int, sms: int) -> int:
    """Key splits of each (b, KV head, block of up to 32 query heads):
    doubled from 1 while the grid has fewer than 2 blocks an SM and every
    split keeps at least ``MIN_SPLIT_KEYS`` keys, at most ``MAX_SPLIT``.
    It depends on the cache length ``t``, the number of such ``groups`` and
    the card's ``sms`` only, never on ``kv_len``."""
    n = 1
    while (n < MAX_SPLIT and groups * n < 2 * sms
           and t >= 2 * n * MIN_SPLIT_KEYS):
        n *= 2
    return n


def rounds_p(dtype: torch.dtype, group: int, d: int, dv: int) -> bool:
    """Whether the kernel runs the products on tensor cores (bf16, a group
    of 8 to 16 query heads padded to the 16 rows of ``mma.sync``, D a
    multiple of 16 and Dv of 8), and so rounds P to bf16 before P·V."""
    return (dtype == torch.bfloat16 and 8 <= min(group, MAX_BLOCK_HEADS) <= 16
            and d % 16 == 0 and dv % 8 == 0)


def groups_of(b: int, h: int, hkv: int) -> int:
    """Blocks a key split has: one per (b, KV head, up to 32 query heads)."""
    return b * hkv * -(-(h // hkv) // MAX_BLOCK_HEADS)


def _sms(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_count[idx]


def smem_bytes(dtype: torch.dtype, d: int, dv: int, group: int) -> int:
    """Dynamic shared memory of one block, in bytes (builds the library)."""
    fn = _build.function("flash_decode_smem", [ctypes.c_int] * 4)
    return fn(torch.empty((), dtype=dtype).element_size(), d, dv, group)


def _scratch_for(dev, b, h, hkv, dv, nsplit):
    """The merge's fp32 partials and per-group counters for this shape,
    allocated at its first call and kept: every launch leaves the counters
    at 0, so a CUDA graph may replay the launch.  Calls of one shape on two
    streams at once would share them."""
    key = (dev, b, h, hkv, dv, nsplit)
    if key not in _scratch:
        n = _build.function("flash_decode_scratch", [ctypes.c_int] * 5)
        n.restype = ctypes.c_longlong
        _scratch[key] = (
            torch.empty(max(n(b, h, hkv, dv, nsplit), 1), dtype=torch.float32,
                        device=dev),
            torch.zeros(groups_of(b, h, hkv), dtype=torch.int32, device=dev))
    return _scratch[key]


def _aligned16(t: torch.Tensor) -> bool:
    """Rows of the (B,Hkv,T,D) ``t`` start on 16 bytes: its base, its
    first three strides and its head dim, in bytes."""
    el = t.element_size()
    return (t.data_ptr() % 16 == 0 and t.shape[-1] * el % 16 == 0
            and all(s * el % 16 == 0 for s in t.stride()[:3]))


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor, *, scale=None) -> torch.Tensor:
    """q:(B,H,D) k/v:(B,Hkv,T,D) kv_len:(B,) int32, CUDA -> (B,H,Dv).

    ``kv_len`` stays on the device: the kernel reads it, so the call needs
    no host sync.  Strides as in ``flash_attention_fwd``: the model's
    (B,T,Hkv,D) cache passes as its transposed view.  K/V rows that start
    on 16 bytes (the model's cache) are loaded 16 bytes at a time, others
    element by element.
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
    if d > MAX_KEY_DIM or dv > MAX_VALUE_DIM:
        raise ValueError(f"head dims D={d}, Dv={dv} over the kernel's "
                         f"{MAX_KEY_DIM}/{MAX_VALUE_DIM}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the head dimension must be contiguous")
    scale = d ** -0.5 if scale is None else float(scale)
    out = torch.empty((b, h, dv), dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 10)(*q.stride()[:2], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:2])
    nsplit = split_count(t, groups_of(b, h, hkv), _sms(dev))
    vec = int(_aligned16(k) and _aligned16(v))
    ws, counters = _scratch_for(dev, b, h, hkv, dv, nsplit)
    fn = _build.function(_ENTRY[q.dtype], _ARGS)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                 out.data_ptr(), ws.data_ptr(), counters.data_ptr(), b, h,
                 hkv, t, d, dv, strides, scale, nsplit, vec,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_decode")
    launches += 1
    return out
