"""The port's Multi-head Latent Attention (repro_torch.models.mla) and the
MLA models (minicpm3_4b, deepseek_v2_236b's MoE + MLA) against the JAX
package's.

Weights come from the JAX package's ``init_params`` and are converted key
for key; inputs are drawn from a seed with numpy.  The port's ``"kernel"``
path (on the CPU the kernels' plain versions) is held against JAX's
``"chunked"``, which JAX runs for MLA whatever ``attn_impl`` says, and
``"chunked"``/``"full"`` against the same, at atol = rtol = 1e-4, the
model tests' tolerance (tests/test_torch_model.py).  The decode cache's
two leaves are views of one buffer in the port (``mla.latent_cache``);
JAX's decode cache converts to that layout (``convert.cache_from_numpy``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import api as japi
from repro.models import common as jcommon
from repro.models import mla as jmla
from repro.models import transformer as jtf
from repro_torch.configs import get_config as torch_config
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.models import common as tcommon
from repro_torch.models import mla as tmla
from repro_torch.models import transformer as ttf
from torch_parity import close

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
# (d_model, heads, q_lora, kv_lora, qk_nope, qk_rope, v_head): the toy
# widths of tests/test_moe_mla.py, the same without a query compression,
# and the reduced configs' (repro/configs/base.py::reduced)
WIDTHS = [(64, 4, 32, 16, 8, 8, 16), (64, 4, 0, 16, 8, 8, 16),
          (128, 4, 64, 32, 16, 16, 32)]
IMPLS = [("chunked", "kernel"), ("chunked", "chunked"), ("full", "full")]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _layer_params(width, seed=0):
    d, h, q_lora, kv_lora, nope, rope, v = width
    spec = jmla.mla_spec(d, h, q_lora=q_lora, kv_lora=kv_lora, qk_nope=nope,
                         qk_rope=rope, v_head=v)
    jp = jcommon.init_params(spec, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(_np(jp), "cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _positions(b, s, offset=0):
    pos = np.broadcast_to(np.arange(offset, offset + s), (b, s)).copy()
    return jnp.asarray(pos), torch.from_numpy(pos)


@pytest.mark.parametrize("jax_impl,torch_impl", IMPLS)
@pytest.mark.parametrize("width", WIDTHS)
def test_mla_layer_matches_jax(width, jax_impl, torch_impl):
    """Output, and the latent c_kv and rope key the prefill caches, against
    JAX's ``mla_layer`` and ``mla_compress_kv``."""
    jp, tp = _layer_params(width)
    b, s = 2, 24
    x = _x((b, s, width[0]), 1)
    jpos, tpos = _positions(b, s)
    want = jmla.mla_layer(jp, jnp.asarray(x), jpos, impl=jax_impl, chunk=16)
    jckv, jkrope = jmla.mla_compress_kv(jp, jnp.asarray(x), jpos, 10000.0,
                                        width[3])
    got, ckv, krope = tmla.mla_layer(tp, torch.from_numpy(x), tpos,
                                     impl=torch_impl, chunk=16)
    close(want, got, **TOL, what="mla_layer")
    close(jckv, ckv, **TOL, what="c_kv")
    close(jkrope, krope, **TOL, what="k_rope")


@pytest.mark.parametrize("width", WIDTHS)
def test_mla_decode_and_cache_match_jax(width):
    """A latent cache filled from a 12- and a 9-token prefix, then three
    absorbed-weight decode steps at ragged fills: outputs and both cache
    leaves against JAX's ``mla_decode_layer``, whose caches are separate
    arrays; the port's stay views of one buffer."""
    jp, tp = _layer_params(width, seed=2)
    d, kv_lora, rope = width[0], width[3], width[5]
    b, s, t = 2, 12, 16
    x = _x((b, s + 3, d), 3)
    jpos, _ = _positions(b, s)
    ckv, krope = jmla.mla_compress_kv(jp, jnp.asarray(x[:, :s]), jpos,
                                      10000.0, kv_lora)
    fill = np.array([12, 9], np.int32)
    mask = (np.arange(t)[None, :s] < fill[:, None])[..., None]
    jckv = np.zeros((b, t, kv_lora), np.float32)
    jkrope = np.zeros((b, t, rope), np.float32)
    jckv[:, :s] = np.where(mask, np.asarray(ckv), 0.0)
    jkrope[:, :s] = np.where(mask, np.asarray(krope), 0.0)
    cache = cache_from_numpy({"ckv": jckv, "krope": jkrope}, "cpu")
    buf = tmla.latent_rows(cache["ckv"], cache["krope"])
    jckv, jkrope = jnp.asarray(jckv), jnp.asarray(jkrope)
    for i in range(3):
        xt = x[:, s + i:s + i + 1]
        want, jckv, jkrope = jmla.mla_decode_layer(
            jp, jnp.asarray(xt), jckv, jkrope, jnp.asarray(fill),
            jnp.asarray(fill))
        got, _, _ = tmla.mla_decode_layer(
            tp, torch.from_numpy(xt), cache["ckv"], cache["krope"],
            torch.from_numpy(fill), torch.from_numpy(fill))
        close(want, got, **TOL, what=f"decode step {i}")
        close(jckv, cache["ckv"], **TOL, what=f"ckv after step {i}")
        close(jkrope, cache["krope"], **TOL, what=f"krope after step {i}")
        fill = fill + 1
    assert buf.data_ptr() == cache["ckv"].data_ptr()
    close(np.concatenate([np.asarray(jckv), np.asarray(jkrope)], -1), buf,
          **TOL, what="the shared buffer")


def test_mla_decode_equals_decompressed_attention():
    """tests/test_moe_mla.py's absorption check in the port: the
    compressed-cache decode of token s equals the full layer's output
    there, at that test's 2e-4."""
    jp, tp = _layer_params(WIDTHS[0])
    b, s = 2, 12
    x = torch.from_numpy(_x((b, s + 1, 64), 4))
    _, pos = _positions(b, s + 1)
    want = tmla.mla_layer(tp, x, pos, impl="full")[0][:, -1]
    _, ckv, krope = tmla.mla_layer(tp, x[:, :s], pos[:, :s], impl="full")
    spec = ttf.decode_cache_spec(
        torch_config("minicpm3_4b").reduced().replace(
            kv_lora=16, qk_rope=8, dtype="float32"), b, s + 4)
    cache = ttf.init_cache(spec, "cpu")["layers"]
    c0 = {k: v[0] for k, v in cache.items()}
    c0["ckv"][:, :s], c0["krope"][:, :s] = ckv, krope
    kv_len = torch.full((b,), s, dtype=torch.int32)
    got, _, _ = tmla.mla_decode_layer(tp, x[:, s:], c0["ckv"], c0["krope"],
                                      kv_len, kv_len)
    close(want, got[:, 0], rtol=2e-4, atol=2e-4, what="absorbed decode")


def test_latent_cache_is_one_buffer_and_the_decode_needs_it():
    """``latent_cache`` lays the pair out as views of one buffer; writing a
    view writes the buffer.  Two separate tensors are refused by the
    decode rather than copied each tick."""
    spec = ttf._attn_cache_spec(torch_config("minicpm3_4b").replace(
        dtype="float32"), 2, 8)
    assert {k: (s.shape, s.axes) for k, s in spec.items()} == {
        "ckv": ((2, 8, 256), ("batch", "kv_seq", None)),
        "krope": ((2, 8, 32), ("batch", "kv_seq", None))}
    cache = tmla.latent_cache(spec["ckv"], spec["krope"], "cpu")
    rows = tmla.latent_rows(cache["ckv"], cache["krope"])
    assert rows.shape == (2, 8, 288)
    cache["krope"][1, 3] = 7.0
    cache["ckv"][0, 5] = 2.0
    assert (rows[1, 3, 256:] == 7.0).all() and (rows[0, 5, :256] == 2.0).all()
    assert rows.sum() == 7.0 * 32 + 2.0 * 256
    with pytest.raises(ValueError, match="views of one buffer"):
        tmla.latent_rows(torch.zeros(2, 8, 256), torch.zeros(2, 8, 32))
    jp, tp = _layer_params(WIDTHS[0])
    kv_len = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="views of one buffer"):
        tmla.mla_decode_layer(tp, torch.zeros(2, 1, 64),
                              torch.zeros(2, 8, 16), torch.zeros(2, 8, 8),
                              kv_len, kv_len)


def _models(arch, jax_impl, torch_impl, **overrides):
    jc = jax_config(arch).reduced().replace(dtype="float32",
                                            attn_impl=jax_impl, **overrides)
    tc = torch_config(arch).reduced().replace(dtype="float32",
                                              attn_impl=torch_impl,
                                              **overrides)
    jp = jcommon.init_params(japi.param_spec(jc), jax.random.PRNGKey(0))
    return jc, jp, tc, params_from_numpy(_np(jp), "cpu")


def _close_caches(tcache, jcache, what):
    flat_j = jax.tree_util.tree_leaves_with_path(jcache)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tcache))
    assert len(flat_t) == len(flat_j)
    for path, leaf in flat_j:
        close(leaf, flat_t[path], **TOL, what=f"{what} {path}")


@pytest.mark.parametrize("jax_impl,torch_impl", IMPLS[:2])
@pytest.mark.parametrize("arch", ["minicpm3_4b", "deepseek_v2_236b"])
def test_mla_prefill_and_decode_match_jax(arch, jax_impl, torch_impl):
    """The reduced models: a 24-token prefill of 2 rows into a 64-row
    cache and 4 greedy decode steps, logits and caches against JAX's
    ``lm_prefill`` / ``lm_decode``; then one more decode step of the port
    from JAX's cache converted (``cache_from_numpy``)."""
    jc, jp, tc, tp = _models(arch, jax_impl, torch_impl)
    tokens = np.random.default_rng(0).integers(0, jc.vocab, (2, 24))
    jl, jcache = jtf.lm_prefill(jc, jp, jnp.asarray(tokens, jnp.int32), 64)
    tl, tcache = ttf.lm_prefill(tc, tp, torch.from_numpy(tokens), 64)
    close(jl, tl, **TOL, what="prefill logits")
    _close_caches(tcache, jcache, "prefill cache")
    kv_len = np.array([24, 24], np.int32)
    for _ in range(4):
        tok = np.array(jnp.argmax(jl, axis=-1))[:, None]
        jl, jcache = jtf.lm_decode(jc, jp, jnp.asarray(tok, jnp.int32),
                                   jcache, jnp.asarray(kv_len))
        tl, tcache = ttf.lm_decode(tc, tp, torch.from_numpy(tok), tcache,
                                   torch.from_numpy(kv_len))
        close(jl, tl, **TOL, what="decode logits")
        kv_len += 1
    _close_caches(tcache, jcache, "decode cache")
    tok = np.array(jnp.argmax(jl, axis=-1))[:, None]
    want, _ = jtf.lm_decode(jc, jp, jnp.asarray(tok, jnp.int32), jcache,
                            jnp.asarray(kv_len))
    got, _ = ttf.lm_decode(tc, tp, torch.from_numpy(tok),
                           cache_from_numpy(_np(jcache), "cpu"),
                           torch.from_numpy(kv_len))
    close(want, got, **TOL, what="decode from JAX's cache")


@pytest.mark.parametrize("arch", ["minicpm3_4b", "deepseek_v2_236b"])
def test_mla_decode_consistent_with_jax_forward(arch):
    """tests/test_arch_smoke.py's check across the packages: the port's
    prefill of 16 tokens and one decode step give JAX's ``lm_forward``
    logits of the 17th position (capacity factor 16, so the MoE's
    sequence-wide dropping does not differ between the two)."""
    jc, jp, tc, tp = _models(arch, "chunked", "kernel",
                             capacity_factor=16.0)
    toks = np.random.default_rng(0).integers(0, jc.vocab, (2, 17))
    full = jtf.lm_forward(jc, jp, jnp.asarray(toks, jnp.int32))
    pre, cache = ttf.lm_prefill(tc, tp, torch.from_numpy(toks[:, :16]), 24)
    close(full[:, 15], pre, **TOL, what="prefill")
    got, _ = ttf.lm_decode(tc, tp, torch.from_numpy(toks[:, 16:]), cache,
                           torch.full((2,), 16, dtype=torch.int32))
    close(full[:, 16], got, **TOL, what="decode")


def test_mla_forward_matches_jax():
    jc, jp, tc, tp = _models("minicpm3_4b", "chunked", "kernel")
    tokens = np.random.default_rng(1).integers(0, jc.vocab, (2, 32))
    close(jtf.lm_forward(jc, jp, jnp.asarray(tokens, jnp.int32)),
          ttf.lm_forward(tc, tp, torch.from_numpy(tokens)), **TOL,
          what="lm_forward")


def test_mla_cache_counts_latent_rows_only():
    """The decode cache holds kv_lora + qk_rope values a token and layer,
    whatever the head count: 288 for minicpm3_4b's 40 heads (a GQA cache of
    its widths would hold 40 x (96 + 64) = 6400)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.models import api
    cfg = torch_config("minicpm3_4b")
    spec = api.cache_spec(cfg, InputShape("e", 1024, 4, "decode"))
    per_token = tcommon.count_params(spec) // (cfg.n_layers * 4 * 1024)
    assert per_token == cfg.kv_lora + cfg.qk_rope == 288
