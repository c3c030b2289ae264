"""Hand-scheduled collectives of the port, after
``repro/parallel/collectives.py``.

* ``compressed_psum``      — hierarchical gradient reduction: full-
  precision reduce inside a pod, top-k+int8 (error feedback) on the
  cross-pod leg.
* ``flash_decode_shardmap``— sequence-parallel decode attention: each
  device holds a KV-cache shard, computes partial (max, sum, acc) and
  combines them with two small all-reduces.

The returned functions are what JAX's ``shard_map`` bodies are: each
device calls them with its local blocks and gets the replicated result.
JAX computes both in plain jnp inside ``shard_map`` (no Pallas kernel),
so plain PyTorch over ``parallel.comm``'s collectives is the port.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..tree import leaves, unflatten
from . import comm


def _topk_int8_wire(x, k_fraction: float):
    """(values_int8, indices, scale) — what actually crosses the pod link."""
    flat = x.reshape(-1)
    k = max(1, int(flat.shape[0] * k_fraction))
    idx = torch.topk(flat.abs(), k).indices
    kept = flat[idx]
    scale = torch.clamp(kept.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(kept / scale), -127, 127).to(torch.int8)
    return q, idx, scale


def compressed_psum(mesh, *, pod_axis: str = "pod",
                    inner_axes: Tuple[str, ...] = ("data",),
                    k_fraction: float = 0.05):
    """Build fn(grads (this device's, whole shape), errs) -> (g, errs).

    Protocol per tensor:
      1. all-reduce over the intra-pod axes (full precision);
      2. add the error-feedback residual; top-k + int8 encode;
      3. all-reduce the DENSE reconstruction over the pod axis (on a real
         wire the (int8 values, indices) pairs are exchanged; the bytes
         are accounted in ``optim.compression.compressed_bytes``);
      4. new residual = input - reconstruction (stays local).
    """

    def reduce_one(g, err):
        g = comm.all_reduce(g.clone(), mesh, inner_axes)
        g_in = g + err
        q, idx, scale = _topk_int8_wire(g_in, k_fraction)
        recon = torch.zeros_like(g_in.reshape(-1))
        recon[idx] = q.to(g_in.dtype) * scale
        recon = recon.reshape(g_in.shape)
        new_err = g_in - recon
        return comm.all_reduce(recon, mesh, pod_axis), new_err

    def fn(grads, errs):
        pairs = [reduce_one(g, e) for g, e in zip(leaves(grads),
                                                  leaves(errs), strict=True)]
        return (unflatten(grads, [p[0] for p in pairs]),
                unflatten(errs, [p[1] for p in pairs]))

    return fn


def flash_decode_shardmap(mesh, seq_axis: str = "model"):
    """fn(q (B,H,D), k (B,T_local,H,D), v (B,T_local,H,D)) -> (B,H,D), with
    this device's block of T along ``seq_axis``.

    Each device computes its local (m, l, acc) in fp32; an all-reduce MAX
    of m and an all-reduce SUM of the corrected l and acc combine them:
    out = sum_i exp(m_i - m) * acc_i / sum_i exp(m_i - m) * l_i.
    """

    def fn(q, k, v):
        scale = q.shape[-1] ** -0.5
        s = torch.einsum("bhd,bthd->bht", q.float(), k.float()) * scale
        m_loc = s.amax(dim=-1)                          # (B,H)
        p = torch.exp(s - m_loc[..., None])
        l_loc = p.sum(dim=-1)
        acc = torch.einsum("bht,bthd->bhd", p, v.float())
        m = comm.all_reduce(m_loc.clone(), mesh, seq_axis, "max")
        corr = torch.exp(m_loc - m)
        l = comm.all_reduce(l_loc * corr, mesh, seq_axis)
        acc = comm.all_reduce(acc * corr[..., None], mesh, seq_axis)
        return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)

    return fn
