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
"""
from __future__ import annotations

from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor

from ..kernels import ops
from .attention import _scatter_kv, attend_chunked, attend_full
from .common import ParamSpec, apply_rope, rmsnorm, rmsnorm_spec


def mla_spec(d_model: int, n_heads: int, *, q_lora: int, kv_lora: int,
             qk_nope: int, qk_rope: int, v_head: int) -> Dict[str, ParamSpec]:
    sp: Dict[str, ParamSpec] = {}
    if q_lora > 0:
        sp["wq_a"] = ParamSpec((d_model, q_lora), ("embed", None))
        sp["q_norm"] = rmsnorm_spec(q_lora)["scale"]
        sp["wq_b"] = ParamSpec((q_lora, n_heads, qk_nope + qk_rope),
                               (None, "heads", None))
    else:
        sp["wq"] = ParamSpec((d_model, n_heads, qk_nope + qk_rope),
                             ("embed", "heads", None))
    sp["wkv_a"] = ParamSpec((d_model, kv_lora + qk_rope), ("embed", None))
    sp["kv_norm"] = rmsnorm_spec(kv_lora)["scale"]
    sp["wkv_b"] = ParamSpec((kv_lora, n_heads, qk_nope + v_head),
                            (None, "heads", None))
    sp["wo"] = ParamSpec((n_heads, v_head, d_model), ("heads", None, "embed"))
    return sp


def _mla_dims(params):
    kv_lora = params["kv_norm"].shape[0]
    n_heads = params["wkv_b"].shape[1]
    qk_rope = params["wkv_a"].shape[1] - kv_lora
    wq = params["wq_b"] if "wq_b" in params else params["wq"]
    qk_nope = wq.shape[2] - qk_rope
    v_head = params["wkv_b"].shape[2] - qk_nope
    return kv_lora, n_heads, qk_nope, qk_rope, v_head


def mla_project_q(params, x, positions, rope_theta, qk_nope, qk_rope,
                  plain: bool = False):
    if "wq_a" in params:
        cq = torch.einsum("bsd,dr->bsr", x, params["wq_a"])
        cq = rmsnorm({"scale": params["q_norm"]}, cq, plain=plain)
        q = torch.einsum("bsr,rhk->bshk", cq, params["wq_b"])
    else:
        q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    q_nope, q_rope = q.split([qk_nope, qk_rope], dim=-1)
    return q_nope, apply_rope(q_rope, positions, rope_theta)


def mla_compress_kv(params, x, positions, rope_theta, kv_lora,
                    plain: bool = False):
    ckv = torch.einsum("bsd,dr->bsr", x, params["wkv_a"])
    c_kv, k_rope = ckv.split([kv_lora, ckv.shape[-1] - kv_lora], dim=-1)
    c_kv = rmsnorm({"scale": params["kv_norm"]}, c_kv, plain=plain)
    return c_kv, apply_rope(k_rope, positions, rope_theta)  # one shared head


def mla_layer(params, x, positions, *, rope_theta: float = 10000.0,
              impl: str = "chunked", chunk: int = 1024, plain: bool = False):
    """Train/prefill MLA: decompress and run standard attention.  Returns
    ``(out, c_kv, k_rope)``: the latent and rope key (B,S,·) that the
    prefill writes to the cache, computed once."""
    kv_lora, h, qk_nope, qk_rope, v_head = _mla_dims(params)
    q_nope, q_rope = mla_project_q(params, x, positions, rope_theta,
                                   qk_nope, qk_rope, plain)
    c_kv, k_rope = mla_compress_kv(params, x, positions, rope_theta, kv_lora,
                                   plain)
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
    return torch.einsum("bshd,hdm->bsm", o, params["wo"]), c_kv, k_rope


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
    is decompressed by W_uv once.  Returns ``(out, cache_ckv,
    cache_krope)``.
    """
    kv_lora, h, qk_nope, qk_rope, v_head = _mla_dims(params)
    pos = position[:, None] if position.dim() == 1 else position
    q_nope, q_rope = mla_project_q(params, x, pos, rope_theta, qk_nope,
                                   qk_rope)
    c_kv, k_rope = mla_compress_kv(params, x, pos, rope_theta, kv_lora)
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
    return out, cache_ckv, cache_krope
