"""Gradient compression for the cross-pod reduction (top-k + int8, with
error feedback), after ``repro/optim/compression.py``.

  * top-k sparsification (per tensor, by magnitude),
  * int8 quantization of the surviving values (per-tensor scale),
  * error feedback: the residual is added back next step, so the
    compression bias does not accumulate (Karimireddy et al. 2019).

``torch.topk`` may pick other indices than ``lax.top_k`` among equal
magnitudes; without ties the two packages compress to the same bits.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch


class Compressed(NamedTuple):
    values_i8: Any     # int8 quantized surviving values
    indices: Any       # int32 flat indices
    scale: Any         # fp32 per-tensor scale
    shape: Any         # static


def compress_topk_int8(g, k_fraction: float = 0.05) -> Tuple[Compressed, Any]:
    """Compress one tensor; returns (compressed, residual_error)."""
    flat = g.reshape(-1).float()
    n = flat.shape[0]
    k = max(1, int(n * k_fraction))
    idx = torch.topk(flat.abs(), k).indices
    kept = flat[idx]
    scale = torch.clamp(kept.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(kept / scale), -127, 127).to(torch.int8)
    # residual: what the wire did NOT carry (top-k misses + quant error)
    recon = torch.zeros_like(flat)
    recon[idx] = q.float() * scale
    err = (flat - recon).reshape(g.shape)
    return Compressed(values_i8=q, indices=idx.to(torch.int32), scale=scale,
                      shape=tuple(g.shape)), err


def decompress_topk_int8(c: Compressed):
    n = 1
    for d in c.shape:
        n *= d
    flat = torch.zeros((n,), dtype=torch.float32, device=c.values_i8.device)
    flat[c.indices.long()] = c.values_i8.float() * c.scale
    return flat.reshape(c.shape)


def error_feedback_update(g, err_state, k_fraction: float = 0.05):
    """One error-feedback round for a single tensor.

    Returns (decompressed_gradient, new_error_state); in one process
    compress -> decompress models the wire losslessly.
    """
    comp, err = compress_topk_int8(g + err_state, k_fraction)
    return decompress_topk_int8(comp), err


def compressed_bytes(c: Compressed) -> int:
    """Wire size of one compressed tensor (int8 vals + int32 idx + scale)."""
    k = c.values_i8.shape[0]
    return k * 1 + k * 4 + 4
