"""Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3), after
``repro/models/mla.py``.

Keys and values are compressed into a small latent ``c_kv`` (kv_lora)
plus a per-token shared RoPE key; the decode cache stores only the latent
and the rope key, and decoding runs in the compressed space by weight
absorption.

The prefill path decompresses to per-head K/V and runs standard attention:
``impl="kernel"`` through ``ops.flash_attention`` (the JAX package swaps
its ``"pallas"`` for ``"chunked"`` here; the port runs the kernel, whose
contract takes minicpm3_4b's q/k 96 and v 64 and deepseek_v2_236b's 192
and 128).  The decode is an MQA decode through ``ops.flash_decode``: the
query ``[q_nope·W_uk | q_rope]`` of every head against the one KV head
whose key is ``[c_kv | k_rope]`` and whose value is ``c_kv``.

The decode cache: the JAX package keeps "ckv" (B,T,kv_lora) and "krope"
(B,T,qk_rope) as two leaves.  The port keeps the two keys, but as views
of one (B,T,kv_lora + qk_rope) buffer (:func:`latent_cache`), so the
decode's key is that buffer as it stands and its value a prefix of each
row, with no copy a tick; the kernel reads each row once, the value from
the staged key row (deepseek_v2_236b's 576 / 512 fit its shared memory
only so).

In a tensor-parallel mesh step (``parallel.tensor``) whose wq_b (wq
where q_lora is 0), wkv_b and wo are this device's block of the heads,
as JAX's rules put "heads" on "model", a layer computes those heads:
every device projects the whole input through the whole wq_a and wkv_a
and their norms (their gradients summed over the axis, since each
device's heads use them), decompresses its heads' keys and values, and
its wo block's partial output is summed over the blocks
(``attention.heads_input`` / ``heads_output``, as GQA's).  The latent
c_kv and k_rope come out whole on every device, so the prefill writes
the whole latent cache, which stays whole over "model", and the decode
runs this device's heads against it with every device writing the same
new row.  Heads that do not divide the axis run whole on every device.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

from ..kernels import ops
from ..parallel import tensor
from .attention import (WO_AXES, WQ_AXES, _scatter_kv, attend_chunked,
                        attend_full, heads_input, heads_output)
from .common import ParamSpec, apply_rope, rmsnorm, rmsnorm_spec

WQB_AXES = (None, "heads", None)        # wq_b and wkv_b


def mla_spec(d_model: int, n_heads: int, *, q_lora: int, kv_lora: int,
             qk_nope: int, qk_rope: int, v_head: int) -> Dict[str, ParamSpec]:
    sp: Dict[str, ParamSpec] = {}
    if q_lora > 0:
        sp["wq_a"] = ParamSpec((d_model, q_lora), ("embed", None))
        sp["q_norm"] = rmsnorm_spec(q_lora)["scale"]
        sp["wq_b"] = ParamSpec((q_lora, n_heads, qk_nope + qk_rope),
                               WQB_AXES)
    else:
        sp["wq"] = ParamSpec((d_model, n_heads, qk_nope + qk_rope),
                             WQ_AXES)
    sp["wkv_a"] = ParamSpec((d_model, kv_lora + qk_rope), ("embed", None))
    sp["kv_norm"] = rmsnorm_spec(kv_lora)["scale"]
    sp["wkv_b"] = ParamSpec((kv_lora, n_heads, qk_nope + v_head), WQB_AXES)
    sp["wo"] = ParamSpec((n_heads, v_head, d_model), WO_AXES)
    return sp


def head_split(params) -> Optional[tensor.TensorParallel]:
    """The tensor-parallel context where wq_b (wq where q_lora is 0),
    wkv_b and wo are this device's block of the heads, else None (off a
    mesh step, or heads that do not divide the axis: the layer runs
    whole)."""
    tp = tensor.active()
    if tp is None:
        return None
    wq, axes = (params["wq_b"], WQB_AXES) if "wq_b" in params \
        else (params["wq"], WQ_AXES)
    split = {tp.split_dim(w, a) is not None for w, a in (
        (wq, axes), (params["wkv_b"], WQB_AXES), (params["wo"], WO_AXES))}
    if len(split) > 1:
        raise ValueError("MLA's heads split in some of wq, wkv_b and wo "
                         "only")
    return tp if split.pop() else None


def _shared(w, tp: Optional[tensor.TensorParallel]):
    """A leaf that every device of the axis uses whole for its block of
    the heads (wq_a, wkv_a, their norms): its gradient summed over the
    axis."""
    return w if tp is None else tensor.into_split(w, tp)


def _latent_norm(scale, x, tp, plain: bool):
    """RMSNorm of a latent of the whole sequence, which every device of
    the axis computes: its scale's gradient summed over the axis only
    where the heads split (not as the norm of a split stream's rows)."""
    with tensor.whole_stream():
        return rmsnorm({"scale": _shared(scale, tp)}, x, plain=plain)


def _mla_dims(params):
    kv_lora = params["kv_norm"].shape[0]
    n_heads = params["wkv_b"].shape[1]
    qk_rope = params["wkv_a"].shape[1] - kv_lora
    wq = params["wq_b"] if "wq_b" in params else params["wq"]
    qk_nope = wq.shape[2] - qk_rope
    v_head = params["wkv_b"].shape[2] - qk_nope
    return kv_lora, n_heads, qk_nope, qk_rope, v_head


def mla_project_q(params, x, positions, rope_theta, qk_nope, qk_rope,
                  tp: Optional[tensor.TensorParallel], plain: bool = False):
    """(q_nope, rotated q_rope) of ``x`` (the whole sequence): every head,
    or under the layer's head split ``tp`` (:func:`head_split`) this
    device's."""
    if "wq_a" in params:
        cq = torch.einsum("bsd,dr->bsr", x, _shared(params["wq_a"], tp))
        cq = _latent_norm(params["q_norm"], cq, tp, plain)
        q = torch.einsum("bsr,rhk->bshk", cq, params["wq_b"])
    else:
        q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    q_nope, q_rope = q.split([qk_nope, qk_rope], dim=-1)
    return q_nope, apply_rope(q_rope, positions, rope_theta)


def mla_compress_kv(params, x, positions, rope_theta, kv_lora,
                    tp: Optional[tensor.TensorParallel], plain: bool = False):
    """(c_kv, rotated k_rope) of ``x`` (the whole sequence), whole on every
    device of the axis under the layer's head split ``tp``."""
    ckv = torch.einsum("bsd,dr->bsr", x, _shared(params["wkv_a"], tp))
    c_kv, k_rope = ckv.split([kv_lora, ckv.shape[-1] - kv_lora], dim=-1)
    c_kv = _latent_norm(params["kv_norm"], c_kv, tp, plain)
    return c_kv, apply_rope(k_rope, positions, rope_theta)  # one shared head


def mla_layer(params, x, positions, *, rope_theta: float = 10000.0,
              impl: str = "chunked", chunk: int = 1024, plain: bool = False):
    """Train/prefill MLA: decompress and run standard attention.  Returns
    ``(out, c_kv, k_rope)``: the latent and rope key (B,S,·) that the
    prefill writes to the cache, computed once (of the whole sequence
    where ``x`` is this device's rows of a split stream)."""
    kv_lora, h, qk_nope, qk_rope, v_head = _mla_dims(params)
    tp = head_split(params)
    x = heads_input(x, tp)
    q_nope, q_rope = mla_project_q(params, x, positions, rope_theta,
                                   qk_nope, qk_rope, tp, plain)
    c_kv, k_rope = mla_compress_kv(params, x, positions, rope_theta, kv_lora,
                                   tp, plain)
    kv = torch.einsum("bsr,rhk->bshk", c_kv, params["wkv_b"])
    k_nope, v = kv.split([qk_nope, v_head], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        *k_nope.shape[:3], qk_rope)], dim=-1)
    scale = (qk_nope + qk_rope) ** -0.5
    if impl == "full":
        o = attend_full(q, k, v, scale=scale)
    elif impl == "chunked":
        o = attend_chunked(q, k, v, chunk=chunk, scale=scale)
    elif impl == "kernel":
        o = ops.flash_attention(q, k, v, causal=True, scale=scale)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    out = torch.einsum("bshd,hdm->bsm", o, params["wo"])
    return heads_output(out, tp), c_kv, k_rope


def latent_cache(ckv_spec: ParamSpec, krope_spec: ParamSpec,
                 device) -> Dict[str, torch.Tensor]:
    """A zero {"ckv", "krope"} cache whose two leaves are views of one
    (..., T, kv_lora + qk_rope) buffer: ckv its first kv_lora columns,
    krope the rest."""
    r = ckv_spec.shape[-1]
    buf = torch.zeros(ckv_spec.shape[:-1] + (r + krope_spec.shape[-1],),
                      dtype=ckv_spec.dtype, device=device)
    return {"ckv": buf[..., :r], "krope": buf[..., r:]}


def _same_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors view one storage; a fake tensor (the dry run's)
    has no data pointer to compare, and passes."""
    if isinstance(a, FakeTensor) or isinstance(b, FakeTensor):
        return True
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def latent_rows(cache_ckv, cache_krope) -> torch.Tensor:
    """The (..., T, kv_lora + qk_rope) buffer of which ``cache_ckv`` and
    ``cache_krope`` are views (:func:`latent_cache`); raises if they are
    not two neighbouring views of one buffer."""
    r, p = cache_ckv.shape[-1], cache_krope.shape[-1]
    if (cache_ckv.shape[:-1] != cache_krope.shape[:-1]
            or cache_ckv.stride() != cache_krope.stride()
            or cache_ckv.stride(-1) != 1
            or cache_ckv.stride(-2) < r + p
            or not _same_storage(cache_ckv, cache_krope)
            or cache_krope.storage_offset()
            != cache_ckv.storage_offset() + r):
        raise ValueError("the MLA cache's ckv and krope must be views of "
                         "one buffer (models.mla.latent_cache)")
    return cache_ckv.as_strided(cache_ckv.shape[:-1] + (r + p,),
                                cache_ckv.stride(),
                                cache_ckv.storage_offset())


def mla_decode_layer(params, x, cache_ckv, cache_krope, position, kv_len,
                     rope_theta: float = 10000.0):
    """Absorbed-weight decode against the compressed cache.

    cache_ckv (B,T,kv_lora) and cache_krope (B,T,qk_rope), views of one
    buffer (:func:`latent_cache`); the new token's row is written into
    them in place.  Attention runs in latent space as one MQA decode
    through ``ops.flash_decode``: per head the query q_nope·W_uk and its
    rope part against the key [c_kv | k_rope], the value c_kv; the result
    is decompressed by W_uv once.  Under a head split the query holds
    this device's heads (a group of H/m on the one latent head), and
    their outputs are summed over the axis.  Returns ``(out, cache_ckv,
    cache_krope)``.
    """
    kv_lora, h, qk_nope, qk_rope, v_head = _mla_dims(params)
    tp = head_split(params)
    x = heads_input(x, tp)
    pos = position[:, None] if position.dim() == 1 else position
    q_nope, q_rope = mla_project_q(params, x, pos, rope_theta, qk_nope,
                                   qk_rope, tp)
    c_kv, k_rope = mla_compress_kv(params, x, pos, rope_theta, kv_lora, tp)
    rows = latent_rows(cache_ckv, cache_krope)
    _scatter_kv(cache_ckv, c_kv, kv_len)
    _scatter_kv(cache_krope, k_rope, kv_len)

    w_uk = params["wkv_b"][:, :, :qk_nope]                 # (R,H,Dn)
    w_uv = params["wkv_b"][:, :, qk_nope:]                 # (R,H,Dv)
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, w_uk)   # (B,1,H,R)
    q = torch.cat([q_abs, q_rope], dim=-1)
    scale = (qk_nope + qk_rope) ** -0.5
    lat = ops.flash_decode(q, rows[:, :, None, :], cache_ckv[:, :, None, :],
                           kv_len + 1, scale=scale)        # (B,1,H,R)
    o = torch.einsum("bshr,rhd->bshd", lat, w_uv)
    out = torch.einsum("bshd,hdm->bsm", o, params["wo"])
    return heads_output(out, tp), cache_ckv, cache_krope
