"""Flash decode on the card: the wrapper of ``csrc/flash_decode.cu``.

Replaces ``repro/kernels/flash_decode.py::flash_decode``.  The plain
version is ``ref.decode_ref``; ``ops.flash_decode`` picks between them by
device and changes the layout.  The kernel splits the key axis over a
grid of blocks and merges the splits in the same launch, through a small
scratch that the wrapper allocates once per shape; ``ref.decode_split_ref``
is that plan in plain PyTorch.  The split count comes from
:func:`split_count`, which reads the shapes and the SM count and never
``kv_len``, so a call is one launch with no host sync, and a CUDA graph
can capture it.  :func:`plan` is the kernel's plan for a width (output
chunks a lane, query heads a block, ring stages, shared memory), from
shapes alone; the wrapper and the dry run's traced route call it first.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

launches = 0        # kernel launches since the last ops.reset_launch_counts()

_ENTRY = {torch.float32: "flash_decode_f32",
          torch.bfloat16: "flash_decode_bf16"}
_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
         + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p])
# widest rows: a key of MLA's latent decode (deepseek_v2_236b's kv_lora 512
# + qk_rope 64) and a value of 512 (a lane's 4 chunks of 4 dims); a value
# over 256 fits shared memory only as a view of the key's rows
MAX_KEY_DIM = 576
MAX_VALUE_DIM = 512
MAX_SPLIT = 32          # key splits of a group
MIN_SPLIT_KEYS = 32     # keys a split keeps at least: one tile
MAX_BLOCK_HEADS = 32    # query heads a block serves at most; larger groups
                        # take more blocks
SMEM_LIMIT = 232448     # bytes of shared memory a block may have on sm_90
WARPS, TILE, P_STRIDE = 8, 32, 40   # the kernel's warps, keys a tile, and
                                    # floats a row of P
_sm_count = {}
_scratch = {}           # (device, shape) -> (fp32 partials, int32 counters)


class Plan(NamedTuple):
    """How the kernel runs one width: ``chunks`` of 4 output dims a lane,
    ``heads`` query heads a block, ``stages`` of the key ring, and the
    bytes of shared memory a block takes (``smem``)."""
    chunks: int
    heads: int
    stages: int
    smem: int


def _layout_bytes(elsize, d, dv, gb, heads, stages, shared) -> int:
    """The kernel's ``Layout::total``: the ring (each stage a tile of K rows
    and, unless V is read from them, of V rows, each row an odd number of
    16-byte units), q in fp32, its bf16 A fragments on the tensor-core
    path, the scores, P, the softmax state and the partial-acc rows."""
    e = 16 // elsize
    uk, uv = -(-d // e), -(-dv // e)
    rk = 16 * (uk | 1)
    stage = TILE * (rk + (0 if shared else 16 * (uv | 1)))
    tc = elsize == 2 and 8 <= gb <= 16 and d % 16 == 0 and dv % 8 == 0
    few = not tc and gb <= min(4, heads // WARPS)
    rows = gb * (WARPS if few else 1)
    return (stages * stage + gb * uk * e * 4 + (d // 16 * 512 if tc else 0)
            + gb * TILE * 4 + gb * P_STRIDE * 4 + 4 * MAX_BLOCK_HEADS * 4
            + rows * (-(-dv // 4) * 4) * 4)


def _chunks(d: int, dv: int) -> int:
    """4-dim output chunks a lane of the plan for these widths."""
    return 1 if max(d, dv) <= 128 else (2 if d <= 288 and dv <= 256 else 4)


def _heads(chunks: int) -> int:
    """Query heads a block of the plan with ``chunks`` chunks a lane."""
    return 16 if chunks == 4 else MAX_BLOCK_HEADS


def plan(dtype: torch.dtype, d: int, dv: int, group: int,
         shared: bool) -> Plan:
    """The kernel's plan for a key of ``d``, a value of ``dv`` and a GQA
    group of ``group`` query heads, with V read from K's rows where
    ``shared``: rows of at most 128 take a chunk a lane, 32 heads a block
    and 4 stages in bf16, 3 in fp32; a key of at most 288 and a value of at
    most 256 two chunks, 32 heads, 4 / 2 stages; wider rows, up to 576 and
    512, four chunks, 16 heads, 3 / 2 stages.  Raises ValueError on widths
    over those or a layout over the block's shared memory (a value over
    256 staged apart from the key).  Shapes only: the dry run's fake
    tensors reach it; ``csrc/flash_decode.cu``'s ``flash_decode_smem``
    returns the same bytes."""
    if dtype not in _ENTRY:
        raise TypeError(f"flash decode kernel takes one of float32/"
                        f"bfloat16, got {dtype}")
    if not (0 < d <= MAX_KEY_DIM and 0 < dv <= MAX_VALUE_DIM):
        raise ValueError(f"head dims D={d}, Dv={dv} over the kernel's "
                         f"{MAX_KEY_DIM}/{MAX_VALUE_DIM}")
    if shared and dv > d:
        raise ValueError(f"a value of {dv} cannot be read from keys of {d}")
    elsize = torch.empty((), dtype=dtype).element_size()
    chunks = _chunks(d, dv)
    heads = _heads(chunks)
    stages = (3 if chunks == 4 else 4) if elsize == 2 else \
        (3 if chunks == 1 else 2)
    gb = min(group, heads)
    smem = _layout_bytes(elsize, d, dv, gb, heads, stages, shared)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"D={d}, Dv={dv}, {gb} heads a block in {dtype} need {smem} "
            f"bytes of shared memory, over {SMEM_LIMIT}"
            + ("" if shared else ": a value row over 256 must be a view of "
               "the key rows' first columns, which the kernel stages once"))
    return Plan(chunks, heads, stages, smem)


def _one_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors view one storage (a fake tensor's too)."""
    return a.untyped_storage()._cdata == b.untyped_storage()._cdata


def value_in_key(k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the (B,Hkv,T,Dv) ``v`` is the first Dv columns of the rows
    of the (B,Hkv,T,D) ``k``: one storage and base, the same strides (a
    dimension of size 1 is never stepped), Dv <= D.  MLA's latent decode
    hands the kernel such a view (``models.mla.latent_rows``); the kernel
    then stages each row once."""
    return (v.dtype == k.dtype and v.shape[:3] == k.shape[:3]
            and v.shape[-1] <= k.shape[-1]
            and v.storage_offset() == k.storage_offset()
            and all(n == 1 or a == b for n, a, b in
                    zip(k.shape[:3], k.stride()[:3], v.stride()[:3]))
            and _one_storage(k, v))


def split_count(t: int, groups: int, sms: int) -> int:
    """Key splits of each (b, KV head, block of query heads):
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
    """Whether the kernel runs a block's products on tensor cores (bf16,
    8 to 16 query heads a block, padded to the 16 rows of ``mma.sync``, D a
    multiple of 16 and Dv of 8), and so rounds P to bf16 before P·V: a
    group of 128 heads at the widest rows, 16 a block, does.  Of the first
    block, where the last one of a group holds fewer heads."""
    heads = _heads(_chunks(d, dv))
    return (dtype == torch.bfloat16 and 8 <= min(group, heads) <= 16
            and d % 16 == 0 and dv % 8 == 0)


def groups_of(b: int, h: int, hkv: int, d: int, dv: int) -> int:
    """Blocks a key split has: one per (b, KV head, up to the plan's heads
    a block for a key of ``d`` and a value of ``dv``)."""
    return b * hkv * -(-(h // hkv) // _heads(_chunks(d, dv)))


def _sms(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_count[idx]


def smem_bytes(dtype: torch.dtype, d: int, dv: int, group: int,
               shared: bool = False) -> int:
    """Dynamic shared memory of one block, in bytes, as the C launcher
    reckons it (builds the library); :func:`plan` mirrors it."""
    fn = _build.function("flash_decode_smem", [ctypes.c_int] * 5)
    return fn(torch.empty((), dtype=dtype).element_size(), d, dv, group,
              int(shared))


def _scratch_for(dev, b, h, hkv, d, dv, nsplit):
    """The merge's fp32 partials and per-group counters for this shape,
    allocated at its first call and kept: every launch leaves the counters
    at 0, so a CUDA graph may replay the launch.  Calls of one shape on two
    streams at once would share them."""
    key = (dev, b, h, hkv, d, dv, nsplit)
    if key not in _scratch:
        n = _build.function("flash_decode_scratch", [ctypes.c_int] * 6)
        n.restype = ctypes.c_longlong
        _scratch[key] = (
            torch.empty(max(n(b, h, hkv, d, dv, nsplit), 1),
                        dtype=torch.float32, device=dev),
            torch.zeros(groups_of(b, h, hkv, d, dv), dtype=torch.int32,
                        device=dev))
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
    element by element.  A ``v`` that is the first Dv columns of ``k``'s
    rows (:func:`value_in_key`) is read from the staged key rows.
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
    shared = value_in_key(k, v)
    p = plan(q.dtype, d, dv, h // hkv, shared)
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the head dimension must be contiguous")
    scale = d ** -0.5 if scale is None else float(scale)
    out = torch.empty((b, h, dv), dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 10)(*q.stride()[:2], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:2])
    nsplit = split_count(t, groups_of(b, h, hkv, d, dv), _sms(dev))
    vec = int(_aligned16(k) and _aligned16(v))
    ws, counters = _scratch_for(dev, b, h, hkv, d, dv, nsplit)
    fn = _build.function(_ENTRY[q.dtype], _ARGS)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                 out.data_ptr(), ws.data_ptr(), counters.data_ptr(), b, h,
                 hkv, t, d, dv, strides, scale, nsplit, vec, int(shared),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_decode")
    launches += 1
    return out
