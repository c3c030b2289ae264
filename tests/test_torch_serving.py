"""The port's serving engine (repro_torch.serving) against the JAX one.

Same weights (JAX ``init_params``, converted), same prompts, same
scheduling: per-request tokens must be equal, and every prefill and
decode tick's logits must agree at atol = rtol = 1e-4 on the rows that
serve a request.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import api as japi
from repro.models import common as jcommon
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_config as torch_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import transformer as ttf
from repro_torch.serving import Request, ServeConfig, ServingEngine

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


def _setup(jax_impl="pallas", torch_impl="kernel", arch="glm4_9b",
           **overrides):
    jc = jax_config(arch).reduced().replace(dtype="float32",
                                            attn_impl=jax_impl, **overrides)
    tc = torch_config(arch).reduced().replace(dtype="float32",
                                              attn_impl=torch_impl,
                                              **overrides)
    jp = jcommon.init_params(japi.param_spec(jc), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jc, jp, tc, tp


def _record(engine, is_jax):
    """Wrap an engine's prefill and decode to log (kind, active rows,
    logits) per call."""
    log = []
    decode = engine._decode

    def logged_decode(params, tokens, cache, kv_len):
        rows = [r is not None for r in engine.active]
        logits, cache = decode(params, tokens, cache, kv_len)
        log.append(("decode", rows, np.array(logits, np.float32)
                    if is_jax else logits.numpy()))
        return logits, cache
    engine._decode = logged_decode
    if is_jax:
        make = engine._prefill_fn

        def logged_prefill_fn(plen):
            fn = make(plen)

            def run(params, batch):
                logits, cache = fn(params, batch)
                log.append(("prefill", [True], np.array(logits, np.float32)))
                return logits, cache
            return run
        engine._prefill_fn = logged_prefill_fn
    else:
        prefill = engine._prefill

        def logged_prefill(params, batch):
            logits, cache = prefill(params, batch)
            log.append(("prefill", [True], logits.numpy()))
            return logits, cache
        engine._prefill = logged_prefill
    return log


def _serve_both(prompts, max_new, slots, cache_len, **setup):
    """``max_new``: one count for every request, or one per request."""
    jc, jp, tc, tp = _setup(**setup)
    jeng = JServingEngine(jc, jp, JServeConfig(n_slots=slots,
                                               cache_len=cache_len))
    teng = ServingEngine(tc, tp, ServeConfig(n_slots=slots,
                                             cache_len=cache_len))
    jlog, tlog = _record(jeng, True), _record(teng, False)
    if isinstance(max_new, int):
        max_new = [max_new] * len(prompts)
    for i, (p, m) in enumerate(zip(prompts, max_new)):
        jeng.submit(JRequest(uid=i, prompt=p, max_new_tokens=m))
        teng.submit(Request(uid=i, prompt=p, max_new_tokens=m))
    jdone = sorted(jeng.run_until_drained(), key=lambda r: r.uid)
    tdone = sorted(teng.run_until_drained(), key=lambda r: r.uid)
    assert [r.uid for r in tdone] == [r.uid for r in jdone] \
        == list(range(len(prompts)))
    assert [r.output for r in tdone] == [r.output for r in jdone]
    assert teng.steps == jeng.steps
    assert [(k, rows) for k, rows, _ in tlog] == \
        [(k, rows) for k, rows, _ in jlog]
    for (kind, rows, tl), (_, _, jl) in zip(tlog, jlog):
        live = np.flatnonzero(rows)
        np.testing.assert_allclose(tl[live], jl[live], **TOL, err_msg=kind)
    return tc, tp, tdone


def test_engine_matches_jax_engine_continuous_batching():
    """The isolation case of tests/test_serving.py: 5 requests of ragged
    prompts through 3 slots, against the JAX engine on Pallas (interpret)."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, int(rng.integers(3, 9))).astype(np.int32)
               for _ in range(5)]
    _serve_both(prompts, max_new=5, slots=3, cache_len=64)


@pytest.mark.parametrize("slots", [1, 3])
def test_hybrid_engine_matches_jax_engine(slots):
    """Reduced zamba2 (Mamba2 groups + shared attention): the slot row of
    every cache leaf, stacked under one or two layer axes, is written on
    its spec's batch axis.  At one slot JAX's shape guess is ambiguous
    (every leaf has axes of size 1), the spec's axis is not.  Prompts are
    within one SSD chunk (16) or a multiple of it, as the JAX prefill
    needs."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (5, 16, 9, 32)]
    _serve_both(prompts, max_new=5, slots=slots, cache_len=64,
                arch="zamba2_7b")


@pytest.mark.parametrize("slots", [1, 3])
def test_xlstm_engine_matches_jax_engine(slots):
    """Reduced xlstm_125m (3 mLSTM blocks, 1 sLSTM block): a cache of
    recurrent state only, whose leaves nest the slot axis under two or one
    stacking axes; the port's counterpart of tests/test_serving.py's
    test_recurrent_family_serving.  Prompts are within one mLSTM chunk
    (64), as the JAX prefill takes them."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (5, 16, 9, 32, 7)]
    _serve_both(prompts, max_new=[4, 7, 3, 6, 5], slots=slots, cache_len=64,
                arch="xlstm_125m")


@pytest.mark.parametrize("slots", [1, 3])
def test_moe_engine_matches_jax_engine(slots):
    """Reduced deepseek_moe_16b (a dense first layer, then MoE layers) with
    16 experts: 5 requests of ragged prompts and ragged lengths.  A decode
    tick's MoE capacity is shared by every row of the pool; with 16
    experts and top-2 it is 1 at 3 slots (int(3 * 2 / 16 * 4.0)), so pairs
    that meet on an expert drop, free and finished rows' pairs too, as at
    the full model (at the reduced 8 experts nothing would drop).  The
    port feeds a finished or free row what the JAX engine feeds it (its
    last token), so the live rows' logits agree; fed its new token, they
    would not at 3 slots."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (5, 16, 9, 32, 7)]
    _serve_both(prompts, max_new=[3, 9, 4, 6, 8], slots=slots, cache_len=64,
                arch="deepseek_moe_16b", n_experts=16)


@pytest.mark.parametrize("slots", [1, 3])
@pytest.mark.parametrize("arch", ["minicpm3_4b", "llava_next_mistral_7b",
                                  "deepseek_v2_236b"])
def test_mla_and_vlm_engines_match_jax_engine(arch, slots):
    """Reduced minicpm3_4b and deepseek_v2_236b (MLA: the slot row of the
    latent cache is written through its two views of one buffer) and the
    reduced VLM serving text prompts, as the JAX engine does: 5 requests of
    ragged prompts and lengths."""
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (5, 16, 9, 30, 7)]
    _serve_both(prompts, max_new=[3, 7, 4, 6, 5], slots=slots, cache_len=64,
                arch=arch)


def test_engine_matches_jax_engine_until_cache_full():
    """Requests that outlive the cache stop at cache_len - 1 in both."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (10, 4)]
    _, _, done = _serve_both(prompts, max_new=40, slots=2, cache_len=16,
                             jax_impl="chunked", torch_impl="chunked")
    assert [len(r.output) for r in done] == [6, 12]


def _greedy(cfg, params, prompt, n_new, cache_len=64):
    """Prefill + sequential decode without the engine."""
    logits, cache = ttf.lm_prefill(cfg, params,
                                   torch.from_numpy(prompt[None].astype(
                                       np.int64)), cache_len)
    out = [int(logits[0].argmax())]
    kv = torch.tensor([len(prompt)], dtype=torch.int32)
    for _ in range(n_new - 1):
        logits, cache = ttf.lm_decode(cfg, params, torch.tensor([[out[-1]]]),
                                      cache, kv)
        kv += 1
        out.append(int(logits[0].argmax()))
    return out


@pytest.mark.parametrize("slots,arch", [
    pytest.param(1, "glm4_9b", id="1"), pytest.param(3, "glm4_9b", id="3"),
    pytest.param(1, "xlstm_125m", id="xlstm-1"),
    pytest.param(3, "xlstm_125m", id="xlstm-3")])
def test_continuous_batching_isolation(slots, arch):
    """Concurrent requests give the tokens of sequential runs, including at
    one slot, where the slot row is written on its known axis.  The xLSTM's
    rows are independent too: a slot's state is its own."""
    _, _, tc, tp = _setup(arch=arch)
    eng = ServingEngine(tc, tp, ServeConfig(n_slots=slots, cache_len=64))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tc.vocab, int(rng.integers(3, 9)))
               .astype(np.int32) for _ in range(4)]
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=4))
    done = sorted(eng.run_until_drained(), key=lambda r: r.uid)
    assert len(done) == 4
    for r in done:
        assert r.output == _greedy(tc, tp, prompts[r.uid], 4), r.uid


def test_engine_keeps_fill_levels_on_device_and_host_in_step():
    _, _, tc, tp = _setup()
    eng = ServingEngine(tc, tp, ServeConfig(n_slots=2, cache_len=64))
    eng.submit(Request(uid=0, prompt=np.arange(5, dtype=np.int32),
                       max_new_tokens=3))
    eng.step()
    assert eng.kv_len.dtype == torch.int32
    assert eng.kv_len.tolist() == eng.kv_len_host.tolist() == [6, 0]
