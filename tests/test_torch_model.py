"""The port's dense, MoE, hybrid and xLSTM decoders (repro_torch.models)
against the JAX package's.

Weights come from the JAX package's ``init_params`` and are converted key
for key, so both packages compute the same function on the same numbers.
The JAX ``attn_impl="pallas"`` path (Pallas in interpret mode) is held
against the port's ``"kernel"`` path, and ``"chunked"`` against
``"chunked"``, at atol = rtol = 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro_torch.configs import get_config as torch_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttf

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **(tol or TOL))


def _models(arch, jax_impl, torch_impl, **overrides):
    jc = jax_config(arch).reduced().replace(dtype="float32",
                                            attn_impl=jax_impl, **overrides)
    tc = torch_config(arch).reduced().replace(dtype="float32",
                                              attn_impl=torch_impl,
                                              **overrides)
    jp = jcommon.init_params(japi.param_spec(jc), jax.random.PRNGKey(0))
    return jc, jp, tc, params_from_numpy(_np(jp), "cpu")


@pytest.mark.parametrize("jax_impl,torch_impl", [("pallas", "kernel"),
                                                 ("chunked", "chunked")])
@pytest.mark.parametrize("arch", ["glm4_9b", "deepseek_7b",
                                  "deepseek_moe_16b"])
def test_prefill_and_decode_match_jax(arch, jax_impl, torch_impl):
    jc, jp, tc, tp = _models(arch, jax_impl, torch_impl)
    tokens = np.random.default_rng(0).integers(0, jc.vocab, (2, 24))
    jl, jcache = jtf.lm_prefill(jc, jp, jnp.asarray(tokens, jnp.int32), 64)
    tl, tcache = ttf.lm_prefill(tc, tp, torch.from_numpy(tokens), 64)
    _close(tl, jl)
    assert tcache.keys() == jcache.keys()
    for layers in tcache:
        for name in ("k", "v"):
            _close(tcache[layers][name], jcache[layers][name])
    kv_len = np.array([24, 24], np.int32)
    for _ in range(4):
        tok = np.array(jnp.argmax(jl, axis=-1))[:, None]
        jl, jcache = jtf.lm_decode(jc, jp, jnp.asarray(tok, jnp.int32),
                                   jcache, jnp.asarray(kv_len))
        tl, tcache = ttf.lm_decode(tc, tp, torch.from_numpy(tok), tcache,
                                   torch.from_numpy(kv_len))
        _close(tl, jl)
        kv_len += 1
    for layers in tcache:
        for name in ("k", "v"):
            _close(tcache[layers][name], jcache[layers][name])


def test_moe_decode_drops_match_jax():
    """Reduced deepseek_moe_16b (a dense first layer, 3 MoE layers, top-2)
    with 16 experts: a 24-token prefill of 3 rows and 6 decode steps.  A
    decode step's capacity is then int(3 * 2 / 16 * 4.0) = 1, so pairs
    that meet on an expert drop, as at the full model's 64 experts and
    top-6 (at the reduced 8 experts the capacity equals the rows and
    nothing drops)."""
    jc, jp, tc, tp = _models("deepseek_moe_16b", "pallas", "kernel",
                             n_experts=16)
    tokens = np.random.default_rng(7).integers(0, jc.vocab, (3, 24))
    jl, jcache = jtf.lm_prefill(jc, jp, jnp.asarray(tokens, jnp.int32), 64)
    tl, tcache = ttf.lm_prefill(tc, tp, torch.from_numpy(tokens), 64)
    _close(tl, jl)
    kv_len = np.full(3, 24, np.int32)
    for _ in range(6):
        tok = np.array(jnp.argmax(jl, axis=-1))[:, None]
        jl, jcache = jtf.lm_decode(jc, jp, jnp.asarray(tok, jnp.int32),
                                   jcache, jnp.asarray(kv_len))
        tl, tcache = ttf.lm_decode(tc, tp, torch.from_numpy(tok), tcache,
                                   torch.from_numpy(kv_len))
        _close(tl, jl)
        kv_len += 1
    flat_j = jax.tree_util.tree_leaves_with_path(jcache)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tcache))
    assert len(flat_j) == len(flat_t) == 4
    for path, leaf in flat_j:
        _close(flat_t[path], leaf)


def test_moe_forward_matches_jax():
    jc, jp, tc, tp = _models("deepseek_moe_16b", "pallas", "kernel")
    tokens = np.random.default_rng(8).integers(0, jc.vocab, (2, 32))
    _close(ttf.lm_forward(tc, tp, torch.from_numpy(tokens)),
           jtf.lm_forward(jc, jp, jnp.asarray(tokens, jnp.int32)))


def test_forward_matches_jax():
    jc, jp, tc, tp = _models("glm4_9b", "pallas", "kernel")
    tokens = np.random.default_rng(1).integers(0, jc.vocab, (2, 32))
    _close(ttf.lm_forward(tc, tp, torch.from_numpy(tokens)),
           jtf.lm_forward(jc, jp, jnp.asarray(tokens, jnp.int32)))


def _shapes(tree):
    if hasattr(tree, "shape") and hasattr(tree, "axes"):
        return (tuple(tree.shape), tuple(tree.axes), tree.init, tree.scale)
    return {k: _shapes(v) for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["glm4_9b", "deepseek_7b",
                                  "mistral_large_123b", "zamba2_7b",
                                  "deepseek_moe_16b", "xlstm_125m",
                                  "minicpm3_4b", "deepseek_v2_236b",
                                  "llava_next_mistral_7b", "whisper_medium"])
def test_full_param_spec_matches_jax(arch):
    """Full-size configs: same names, shapes, axes and init (nothing is
    allocated)."""
    jspec = japi.param_spec(jax_config(arch))
    tspec = tapi.param_spec(torch_config(arch))
    assert _shapes(tspec) == _shapes(jspec)
    assert tcommon.count_params(tspec) == jcommon.count_params(jspec)


@pytest.mark.parametrize("arch", ["glm4_9b", "minicpm3_4b",
                                  "deepseek_v2_236b",
                                  "llava_next_mistral_7b", "whisper_medium"])
def test_cache_spec_matches_jax(arch):
    """Key for key, axis for axis and in dtype; MLA's latent cache
    ("ckv", "krope"), the VLM's K/V and the encoder-decoder's self and
    cross caches too."""
    from repro.configs.base import InputShape as JShape
    from repro_torch.configs.base import InputShape as TShape
    jc, tc = jax_config(arch), torch_config(arch)
    js = japi.cache_spec(jc, JShape("e", 1024, 4, "decode"))
    ts = tapi.cache_spec(tc, TShape("e", 1024, 4, "decode"))
    assert _shapes(ts) == _shapes(js)
    assert jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda s: jnp.dtype(s.dtype).name, js, is_leaf=jcommon.is_spec)) == \
        [str(s.dtype).removeprefix("torch.") for s in
         tcommon.spec_leaves(ts)]


@pytest.mark.parametrize("shape", [(1024, 4), (64, 1)])
def test_moe_cache_spec_matches_jax(shape):
    """deepseek_moe_16b: "dense_layers" for its dense first layer and
    "layers" for its 27 MoE layers, key for key and in dtype."""
    from repro.configs.base import InputShape as JShape
    from repro_torch.configs.base import InputShape as TShape
    jc, tc = jax_config("deepseek_moe_16b"), torch_config("deepseek_moe_16b")
    js = japi.cache_spec(jc, JShape("e", shape[0], shape[1], "decode"))
    ts = tapi.cache_spec(tc, TShape("e", shape[0], shape[1], "decode"))
    assert _shapes(ts) == _shapes(js)
    assert ts["dense_layers"]["k"].shape == (1, shape[1], shape[0], 16, 128)
    assert ts["layers"]["v"].shape == (27, shape[1], shape[0], 16, 128)


@pytest.mark.parametrize("arch,shape", [("zamba2_7b", (1024, 4)),
                                        ("zamba2_7b", (64, 1))])
def test_hybrid_cache_spec_matches_jax(arch, shape):
    """Key for key, with the hybrid's nested stacking and its dtypes (conv
    tail in the activation dtype, SSD state in fp32)."""
    from repro.configs.base import InputShape as JShape
    from repro_torch.configs.base import InputShape as TShape
    jc, tc = jax_config(arch), torch_config(arch)
    js = japi.cache_spec(jc, JShape("e", shape[0], shape[1], "decode"))
    ts = tapi.cache_spec(tc, TShape("e", shape[0], shape[1], "decode"))
    assert _shapes(ts) == _shapes(js)
    assert jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda s: jnp.dtype(s.dtype).name, js, is_leaf=jcommon.is_spec)) == \
        [str(s.dtype).removeprefix("torch.") for s in
         tcommon.spec_leaves(ts)]


@pytest.mark.parametrize("shape", [(1024, 4), (64, 1)])
def test_xlstm_cache_spec_matches_jax(shape):
    """xlstm_125m: recurrent state only, key for key, axis for axis and in
    dtype (fp32): "mlstm" stacked (groups, mLSTM blocks a group) and
    "slstm" stacked (groups); no leaf depends on the cache length."""
    from repro.configs.base import InputShape as JShape
    from repro_torch.configs.base import InputShape as TShape
    jc, tc = jax_config("xlstm_125m"), torch_config("xlstm_125m")
    js = japi.cache_spec(jc, JShape("e", shape[0], shape[1], "decode"))
    ts = tapi.cache_spec(tc, TShape("e", shape[0], shape[1], "decode"))
    assert _shapes(ts) == _shapes(js)
    assert jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda s: jnp.dtype(s.dtype).name, js, is_leaf=jcommon.is_spec)) == \
        [str(s.dtype).removeprefix("torch.") for s in
         tcommon.spec_leaves(ts)]
    assert ts["mlstm"]["C"].shape == (3, 3, shape[1], 4, 192, 192)
    assert ts["slstm"]["h"].shape == (3, shape[1], 4, 192)


@pytest.mark.parametrize("jax_impl,torch_impl", [("pallas", "kernel"),
                                                 ("chunked", "chunked")])
def test_hybrid_prefill_and_decode_match_jax(jax_impl, torch_impl):
    """Reduced zamba2 (7 layers: 2 groups of 3 and 1 rest layer, both
    shared weight sets): a 32-token prefill, two SSD chunks of 16, and 4
    decode steps, logits and every cache leaf."""
    jc, jp, tc, tp = _models("zamba2_7b", jax_impl, torch_impl)
    tokens = np.random.default_rng(5).integers(0, jc.vocab, (2, 32))
    jl, jcache = jtf.lm_prefill(jc, jp, jnp.asarray(tokens, jnp.int32), 64)
    tl, tcache = ttf.lm_prefill(tc, tp, torch.from_numpy(tokens), 64)

    def caches_close():
        flat_j = jax.tree_util.tree_leaves_with_path(jcache)
        flat_t = dict(jax.tree_util.tree_leaves_with_path(tcache))
        assert len(flat_j) == len(flat_t) == 6
        for path, leaf in flat_j:
            _close(flat_t[path], leaf)
    _close(tl, jl)
    caches_close()
    kv_len = np.array([32, 32], np.int32)
    for _ in range(4):
        tok = np.array(jnp.argmax(jl, axis=-1))[:, None]
        jl, jcache = jtf.lm_decode(jc, jp, jnp.asarray(tok, jnp.int32),
                                   jcache, jnp.asarray(kv_len))
        tl, tcache = ttf.lm_decode(tc, tp, torch.from_numpy(tok), tcache,
                                   torch.from_numpy(kv_len))
        _close(tl, jl)
        kv_len += 1
    caches_close()


def test_hybrid_forward_matches_jax():
    """Full-sequence logits, 20 tokens: the Mamba2 layers pad to 32."""
    jc, jp, tc, tp = _models("zamba2_7b", "pallas", "kernel")
    tokens = np.random.default_rng(6).integers(0, jc.vocab, (2, 20))
    _close(ttf.lm_forward(tc, tp, torch.from_numpy(tokens)),
           jtf.lm_forward(jc, jp, jnp.asarray(tokens, jnp.int32)))


def test_hybrid_prefill_off_the_chunk_raises_like_jax():
    jc, jp, tc, tp = _models("zamba2_7b", "chunked", "chunked")
    tokens = np.zeros((1, 20), np.int64)       # over one chunk of 16, not 32
    with pytest.raises(AssertionError):
        jtf.lm_prefill(jc, jp, jnp.asarray(tokens, jnp.int32), 64)
    with pytest.raises(ValueError, match="chunk"):
        ttf.lm_prefill(tc, tp, torch.from_numpy(tokens), 64)


def test_configs_match_jax():
    from repro.configs.base import ARCH_IDS
    import dataclasses
    for arch in ARCH_IDS:
        j = dataclasses.asdict(jax_config(arch))
        t = dataclasses.asdict(torch_config(arch))
        assert t == j, arch


# ---------------------------------------------------------------------------
# Module-level parity: the pieces the model path is built of
# ---------------------------------------------------------------------------


def test_rmsnorm_rope_and_swiglu_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 4, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    pos = np.tile(np.arange(8), (2, 1)) + 5
    tx = torch.from_numpy(x)
    _close(tcommon.rmsnorm({"scale": torch.from_numpy(scale)}, tx, 1e-5),
           jcommon.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)),
           atol=1e-6, rtol=1e-6)
    _close(tcommon.apply_rope(tx, torch.from_numpy(pos), 1e4),
           jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4),
           atol=1e-5, rtol=1e-5)
    w = {k: rng.standard_normal(s).astype(np.float32) * 0.1 for k, s in
         [("w_gate", (32, 64)), ("w_up", (32, 64)), ("w_down", (64, 32))]}
    _close(tcommon.swiglu(params_from_numpy(w, "cpu"), tx),
           jcommon.swiglu({k: jnp.asarray(v) for k, v in w.items()},
                          jnp.asarray(x)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_paths_match_jax(causal):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 96, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 96, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 96, 2, 32)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = jattn.attend_full(jq, jk, jv, causal=causal)
    _close(tattn.attend_full(tq, tk, tv, causal=causal), want, atol=2e-5,
           rtol=2e-5)
    _close(tattn.attend_chunked(tq, tk, tv, causal=causal, chunk=32), want,
           atol=2e-5, rtol=2e-5)


def test_decode_layer_matches_jax():
    """Decode attention, the in-place cache write with its drop semantics
    (a row at kv_len >= T is not written), and the decode layer."""
    rng = np.random.default_rng(4)
    b, t, d_model = 3, 64, 128
    spec = jattn.gqa_spec(d_model, 4, 2, 32)
    jp = jcommon.init_params(spec, jax.random.PRNGKey(1))
    tp = params_from_numpy(_np(jp), "cpu")
    x = rng.standard_normal((b, 1, d_model)).astype(np.float32)
    ck = rng.standard_normal((b, t, 2, 32)).astype(np.float32)
    cv = rng.standard_normal((b, t, 2, 32)).astype(np.float32)
    kv_len = np.array([5, 63, 64], np.int32)     # last row: cache full
    jo, jk, jv = jattn.gqa_decode_layer(jp, jnp.asarray(x), jnp.asarray(ck),
                                        jnp.asarray(cv), jnp.asarray(kv_len),
                                        jnp.asarray(kv_len))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    to, tk2, tv2 = tattn.gqa_decode_layer(
        tp, torch.from_numpy(x), tk, tv, torch.from_numpy(kv_len),
        torch.from_numpy(kv_len))
    assert tk2 is tk and tv2 is tv                # updated in place
    _close(tk, jk, atol=1e-6, rtol=1e-6)
    _close(tv, jv, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(tk[2].numpy(), ck[2])
    # JAX attends over the first min(kv_len + 1, T) rows, as does the port
    _close(to, jo, atol=2e-5, rtol=2e-5)
    lens = np.array([6, 64, 64], np.int32)
    _close(tattn.attend_decode(torch.from_numpy(x[:, :, None, :32].repeat(
        4, 2)), tk, tv, torch.from_numpy(lens)),
        jattn.attend_decode(jnp.asarray(x[:, :, None, :32].repeat(4, 2)), jk,
                            jv, jnp.asarray(lens)), atol=2e-5, rtol=2e-5)


def test_init_params_follows_spec():
    spec = {"w": tcommon.ParamSpec((64, 32), ("embed", "mlp")),
            "e": tcommon.ParamSpec((16, 8), ("vocab", "embed"), init="embed",
                                   scale=0.02),
            "one": tcommon.ParamSpec((8,), ("embed",), init="ones"),
            "zero": tcommon.ParamSpec((8,), ("embed",), init="zeros")}
    g = torch.Generator().manual_seed(0)
    p = tcommon.init_params(spec, g, "cpu")
    assert p["w"].shape == (64, 32) and p["w"].dtype == torch.float32
    assert p["w"].abs().max() <= 2.0 / 8.0 + 1e-6      # fan-in 64
    assert p["e"].abs().max() <= 0.04 + 1e-6
    assert torch.equal(p["one"], torch.ones(8))
    assert torch.equal(p["zero"], torch.zeros(8))
    again = tcommon.init_params(spec, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(p["w"], again["w"])


def test_convert_bfloat16_keeps_bits():
    x = jnp.asarray(np.linspace(-3, 3, 17, dtype=np.float32), jnp.bfloat16)
    t = tensor_from_numpy(np.asarray(x), "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(x, np.float32))
