"""The port's design-space exploration (repro_torch.dse, the uneven split)
against the JAX package, on the CPU.

The same seeded numpy inputs and the same keys go through both packages,
over small spaces like those of ``tests/test_fused.py`` (and, once, the
full ``benchmarks/dse_bench.py`` space).  The gates:

* the encoder: bit-exact over full enumerations;
* prices, Monte Carlo stats and sensitivities: ``ENGINE_RTOL`` (1e-5);
  Monte Carlo never bit for bit, since XLA's ``exp`` and torch's differ
  in the last bit;
* fused against legacy within the port: 1e-6, as the reference holds
  its own two paths;
* the search: the same populations, history and winner for the same key.
"""
import jax
import numpy as np
import pytest
import torch

import repro.dse as J
import repro_torch.dse as T
from repro.core.gradient import optimize_uneven_split as jax_uneven
from repro.dse import search as jsearch
from repro.dse.space import encoded_nre as jax_encoded_nre
from repro_torch import random as tr
from repro_torch.core import CostEngine, SystemBatch, optimize_uneven_split
from repro_torch.dse import search as tsearch
from repro_torch.dse.space import encoded_nre
from repro_torch.launch import portfolio_search as launch
from torch_parity import ENGINE_ATOL, ENGINE_RTOL, close, equal, to_numpy

ENGINE = CostEngine()
FUSED_RTOL = 1e-6          # fused against legacy (tests/test_fused.py)


def _space(mod, **kw):
    d = dict(skus=(mod.SKU("laptop", 200.0, 2e6),
                   mod.SKU("server", 400.0, 5e5)),
             processes=("7nm", "12nm"), integrations=("MCM",),
             chiplet_counts=(1, 2, 4), allow_reuse=True,
             reuse_package_options=(False, True))
    d.update(kw)
    return mod.DesignSpace(**d)


def _three(mod):
    """A three-SKU space with two integrations (test_dse.py's shape)."""
    return mod.DesignSpace(
        skus=(mod.SKU("laptop", 150.0, 2e6), mod.SKU("desktop", 300.0, 1e6),
              mod.SKU("server", 600.0, 3e5)),
        processes=("5nm", "7nm"), integrations=("MCM", "2.5D"),
        chiplet_counts=(1, 2, 3, 4), allow_reuse=True,
        reuse_package_options=(False, True))


def _bench(mod):
    """benchmarks/dse_bench.py's SPACE: 19,707 candidates."""
    return mod.DesignSpace(
        skus=(mod.SKU("laptop", 300.0, 2e6), mod.SKU("desktop", 600.0, 1e6),
              mod.SKU("server", 900.0, 3e5)),
        processes=("5nm", "7nm", "12nm"), integrations=("MCM", "2.5D"),
        chiplet_counts=(1, 2, 3, 4, 6), allow_reuse=True,
        reuse_package_options=(False, True))


def _tkey(seed):
    return tr.PRNGKey(seed, device="cpu")


def _fields(tc):
    return {"re": tc.re.total, "nre": tc.nre.total, "total": tc.total}


# -- the gradient partitioner -------------------------------------------------

@pytest.mark.parametrize("case", [
    ("5nm", "MCM", [300.0, 200.0, 100.0, 100.0, 100.0], 3),   # cost_explorer
    ("7nm", "2.5D", [120.0, 80.0, 60.0, 40.0], 2)])
def test_optimize_uneven_split_matches_jax(case):
    """Both start from 0.01 * normal(PRNGKey(0), (m, n)) and take 500
    steps: the same assignment, the costs at 1e-5."""
    want = jax_uneven(*case)
    got = optimize_uneven_split(*case, device="cpu")
    assert got["assignment"] == want["assignment"]
    assert got["chip_areas"] == want["chip_areas"]
    for k in ("soft_cost", "hard_cost"):
        close(want[k], got[k], rtol=ENGINE_RTOL, what=k)


# -- the encoder ---------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"reuse_within_sku": False},
                                {"allow_reuse": False},
                                {"integrations": ("MCM", "2.5D")}])
def test_encode_batch_full_enumeration_bit_parity(kw):
    """Every candidate of the space, encoded from indices: every leaf
    bit-equal to the JAX encoder's, and priced exactly like the port's
    own host-packed chunk."""
    jsp, tsp = _space(J, **kw), _space(T, **kw)
    assert tsp.size() == jsp.size()
    idx = np.arange(tsp.size())
    want = J.encode_batch(jsp, idx)
    got = T.encode_batch(tsp, idx, device="cpu")
    for f in SystemBatch._LEAVES:
        equal(np.asarray(getattr(want, f)), getattr(got, f), what=f)
    legacy = T.ChunkedEvaluator(tsp, candidates_per_chunk=tsp.size(),
                                fused=False, device="cpu").pack_chunk(
        list(tsp.enumerate_candidates()))
    for flow in ("chip-last", "chip-first"):
        te = _fields(ENGINE.total(got, flow=flow))
        tl = _fields(ENGINE.total(legacy, flow=flow))
        for k in te:
            equal(tl[k], te[k], what=f"{flow} {k}")


def test_encoder_meta_and_index_algebra():
    jsp, tsp = _bench(J), _bench(T)
    assert tsp.encoder().meta == T.EncoderMeta(**vars(jsp.encoder().meta))
    assert tsp.size() == 19707 and tsp.encoder().meta.n_reuse_choices == 24
    sp = _space(T)
    assert [sp.index_of(sp.candidate_at(i))
            for i in range(sp.size())] == list(range(sp.size()))
    assert [sp.candidate_at(i) for i in range(sp.size())] == \
        list(sp.enumerate_candidates())
    with pytest.raises(ValueError):
        sp.index_of(_three(T).candidate_at(0))      # foreign candidate


def test_encoded_nre_matches_segment_sums_and_jax():
    jsp, tsp = _space(J), _space(T)
    idx = np.random.default_rng(3).integers(0, tsp.size(), 64)
    enc = tsp.encoder()
    tables = enc.tables_on("cpu")
    ana = encoded_nre(tables, enc.meta, torch.as_tensor(idx))
    gen = ENGINE.nre(T.encode_batch(tsp, idx, device="cpu"))
    jenc = jsp.encoder()
    ref = jax.device_get(jax_encoded_nre(jenc.tables, jenc.meta, idx))
    for part in ("modules", "chips", "packages", "d2d", "total"):
        a, g = getattr(ana, part), getattr(gen, part)
        close(g, a, rtol=FUSED_RTOL, atol=1e-9, what=f"{part} vs engine")
        close(getattr(ref, part), a, rtol=ENGINE_RTOL, atol=ENGINE_ATOL,
              what=f"{part} vs jax")


# -- the evaluator -------------------------------------------------------

def _arrays_close(want, got, what):
    for f in ("sku_unit_total", "sku_unit_re", "sku_unit_nre",
              "portfolio_cost"):
        close(getattr(want, f), getattr(got, f), rtol=ENGINE_RTOL,
              atol=ENGINE_ATOL, what=f"{what} {f}")
    equal(want.finite, got.finite, what=f"{what} finite")
    assert (want.risk is None) == (got.risk is None)
    assert list(got.risk or {}) == list(want.risk or {})
    for k in (want.risk or {}):
        close(want.risk[k], got.risk[k], rtol=ENGINE_RTOL, what=f"{what} {k}")


@pytest.mark.parametrize("flow", ["chip-last", "chip-first"])
@pytest.mark.parametrize("mc", [False, True])
def test_fused_chunks_match_jax(mc, flow):
    """Every candidate in chunks of 8 (the last one padded): unit prices,
    RE, NRE, portfolio cost and, with a key, the Monte Carlo stats."""
    jsp, tsp = _space(J), _space(T)
    idx = np.arange(tsp.size())
    kw_j = kw_t = {}
    if mc:
        kw_j = dict(mc_key=jax.random.PRNGKey(11), mc_draws=64,
                    mc_quantiles=(0.5, 0.9))
        kw_t = dict(kw_j, mc_key=_tkey(11))
    want = J.ChunkedEvaluator(jsp, candidates_per_chunk=8,
                              flow=flow).evaluate_indices(idx, **kw_j)
    got = T.ChunkedEvaluator(tsp, candidates_per_chunk=8, flow=flow,
                             device="cpu").evaluate_indices(idx, **kw_t)
    equal(want.idx, got.idx, what="idx")
    _arrays_close(want, got, f"{flow} mc={mc}")


def test_fused_object_and_legacy_paths_agree():
    sp = _space(T)
    idx = np.asarray(sorted({int(i) for i in np.random.default_rng(0)
                             .integers(0, sp.size(), 24)}))
    fused = T.ChunkedEvaluator(sp, candidates_per_chunk=8, device="cpu")
    arrays = fused.evaluate_indices(idx)
    cands = [sp.candidate_at(int(i)) for i in idx]
    obj = fused.evaluate(cands)
    equal(arrays.portfolio_cost,
          np.asarray([r.portfolio_cost for r in obj], np.float32),
          what="object API")
    legacy = T.ChunkedEvaluator(sp, candidates_per_chunk=8, fused=False,
                                device="cpu")
    worst = max(abs(a.portfolio_cost - b.portfolio_cost) / b.portfolio_cost
                for a, b in zip(obj, legacy.evaluate(cands)))
    assert worst < FUSED_RTOL
    direct = [T.evaluate_direct(sp, c, device="cpu") for c in cands[:4]]
    for a, d in zip(obj, direct):
        close(d.portfolio_cost, a.portfolio_cost, rtol=ENGINE_RTOL)
    with pytest.raises(RuntimeError):
        legacy.evaluate_indices(idx)
    with pytest.raises(IndexError):
        fused.evaluate_indices(np.asarray([sp.size()]))
    with pytest.raises(ValueError):
        fused.evaluate_indices(np.asarray([], np.int64))


def test_legacy_index_path_matches_jax_and_repeats():
    jsp, tsp = _space(J), _space(T)
    idx = np.arange(0, tsp.size(), 3)
    kw = dict(mc_draws=32, mc_quantiles=(0.5, 0.9))
    want = J.ChunkedEvaluator(jsp, candidates_per_chunk=8, fused=False) \
        .evaluate_indices_legacy(idx, mc_key=jax.random.PRNGKey(5), **kw)
    ev = T.ChunkedEvaluator(tsp, candidates_per_chunk=8, fused=False,
                            device="cpu")
    got = ev.evaluate_indices_legacy(idx, mc_key=_tkey(5), **kw)
    _arrays_close(want, got, "legacy")
    again = ev.evaluate_indices_legacy(idx, mc_key=_tkey(5), **kw)
    for f in ("sku_unit_total", "portfolio_cost"):
        equal(getattr(got, f), getattr(again, f), what=f"rerun {f}")


# -- Monte Carlo and sensitivities --------------------------------------------

def _batches(n=6):
    idx = np.arange(n)
    return J.encode_batch(_space(J), idx), \
        T.encode_batch(_space(T), idx, device="cpu")


@pytest.mark.parametrize("correlated", [True, False])
def test_mc_summary_matches_jax(correlated):
    jb, tb = _batches()
    kw = dict(n_draws=48, correlated=correlated,
              quantiles=(0.05, 0.5, 0.9, 0.95))
    want = J.mc_summary(jb, jax.random.PRNGKey(2), **kw)
    got = T.mc_summary(tb, _tkey(2), **kw)
    assert list(got) == list(want)
    for k in want:
        close(want[k], got[k], rtol=ENGINE_RTOL, atol=1e-3, what=k)
    close(J.mc_totals(jb, jax.random.PRNGKey(2), n_draws=48,
                      correlated=correlated),
          T.mc_totals(tb, _tkey(2), n_draws=48, correlated=correlated),
          rtol=ENGINE_RTOL, what="draws")


def test_mc_re_draws_plus_nre_equal_the_full_draws():
    """NRE is scenario-invariant: in the port (one eager graph), RE-only
    draws plus the NRE row are the full Monte Carlo totals bit for bit."""
    from repro_torch.dse.uncertainty import mc_re_totals_impl
    _, tb = _batches()
    sig = T.Uncertainty().as_array()
    full = T.mc_totals(tb, _tkey(2), n_draws=32)
    re_only = mc_re_totals_impl(tb, _tkey(2), sig, "chip-last", 32)
    equal(full, re_only + ENGINE.nre(tb).total[None, :], what="draws")


def test_portfolio_risk_stats_match_jnp_quantile():
    draws = np.random.default_rng(4).lognormal(18.0, 0.3, (257, 11)) \
        .astype(np.float32)
    qs = (0.05, 0.5, 0.9, 0.97)
    want = J.portfolio_risk_stats(draws, qs)
    got = T.portfolio_risk_stats(torch.from_numpy(draws), qs)
    assert list(got) == list(want)
    for k in want:
        close(want[k], got[k], rtol=ENGINE_RTOL, what=k)
    q = np.asarray([1e6, 2e5, 3e4], np.float32)
    close(J.portfolio_draws(draws[:, :9], q, 3),
          T.portfolio_draws(torch.from_numpy(draws[:, :9]), q, 3),
          rtol=ENGINE_RTOL, what="portfolio_draws")


def test_sensitivities_match_jax():
    jb, tb = _batches(8)
    for flow in ("chip-last", "chip-first"):
        want = J.sensitivities(jb, flow=flow)
        got = T.sensitivities(tb, flow=flow)
        assert list(got) == list(want) == sorted(T.SENSITIVITY_PARAMS)
        for k in want:
            close(want[k], got[k], rtol=ENGINE_RTOL, atol=1e-6,
                  what=f"{flow} {k}")


# -- the search ------------------------------------------------------------

def test_exhaustive_search_finds_the_same_winner():
    jsp, tsp = _three(J), _three(T)
    want = J.exhaustive_search(jsp)
    got = T.exhaustive_search(tsp, device="cpu")
    assert got.best.label == want.best.label
    assert got.n_evaluated == want.n_evaluated == tsp.size()
    close(want.best.portfolio_cost, got.best.portfolio_cost,
          rtol=ENGINE_RTOL)
    risk_j = J.RiskConfig(n_draws=32, quantile=0.9)
    risk_t = T.RiskConfig(n_draws=32, quantile=0.9)
    jsp, tsp = _space(J), _space(T)
    want = J.exhaustive_search(jsp, risk=risk_j, key=jax.random.PRNGKey(4))
    got = T.exhaustive_search(tsp, risk=risk_t, key=_tkey(4), device="cpu")
    assert [r.label for r in got.ranked[:5]] == \
        [r.label for r in want.ranked[:5]]
    assert [p["label"] for p in got.pareto] == \
        [p["label"] for p in want.pareto]


def _step_kw(jsp, risk):
    kw = dict(flow="chip-last", population=12, elite=4, jump_prob=0.15,
              n_draws=0, quantile=0.5)
    if risk:
        kw.update(n_draws=24, quantile=0.9)
    return kw


@pytest.mark.parametrize("risk", [False, True])
def test_generation_steps_breed_the_reference_populations(risk):
    """Six generation steps from the same key and population in both
    packages: the same next population every generation, the same
    generation best, its objective at 1e-5."""
    jsp, tsp = _three(J), _three(T)
    jenc, tenc = jsp.encoder(), tsp.encoder()
    kw = _step_kw(jsp, risk)
    rc = T.RiskConfig(n_draws=24, quantile=0.9) if risk else None
    jstate = J.SearchState.init(jax.random.PRNGKey(21), kw["population"],
                                jsp.size(), J.RiskConfig(
                                    n_draws=24, quantile=0.9)
                                if risk else None)
    tstate = T.SearchState.init(_tkey(21), kw["population"], tsp.size(), rc)
    equal(np.asarray(jstate.pop), tstate.pop, what="initial population")
    equal(np.asarray(jstate.mc_key), tr.key_data(tstate.mc_key),
          what="mc key")
    jqty = np.asarray([s.quantity for s in jsp.skus], np.float32)
    tqty = torch.from_numpy(jqty)
    step = jsearch._gen_step()
    jk, tk = np.asarray(jstate.k_loop), tstate.k_loop
    jpop, tpop = jstate.pop, tstate.pop
    for gen in range(6):
        jk, jgen = jax.random.split(jk)
        tk, tgen = tr.split(tk).unbind(0)
        _, jnext, jbest, jobj = step(jenc.tables, jgen, jpop, jqty,
                                     jstate.mc_key, jstate.sig,
                                     meta=jenc.meta, **kw)
        _, tnext, tbest, tobj = tsearch._gen_step_impl(
            tenc.tables_on("cpu"), tgen, tpop, tqty, tstate.mc_key,
            tstate.sig, meta=tenc.meta, **kw)
        assert int(tbest) == int(jbest), \
            f"gen {gen}: best {int(tbest)} vs {int(jbest)}, objectives " \
            f"{float(tobj)!r} vs {float(jobj)!r}"
        close(float(jobj), float(tobj), rtol=ENGINE_RTOL, what="gen best")
        equal(np.asarray(jnext), tnext, what=f"gen {gen} population")
        jpop, tpop = jnext, tnext


def _history_same(want, got):
    assert len(got.history) == len(want.history)
    for h_w, h_g in zip(want.history, got.history):
        for k in ("generation", "evaluated", "best_label"):
            assert h_g[k] == h_w[k], (k, h_w, h_g)
        for k in ("best_objective", "gen_best"):
            close(h_w[k], h_g[k], rtol=ENGINE_RTOL, what=k)


@pytest.mark.parametrize("risk", [False, True])
def test_portfolio_search_matches_jax(risk):
    jsp, tsp = _three(J), _three(T)
    kw = dict(population=16, generations=6, elite=4)
    want = J.portfolio_search(jsp, jax.random.PRNGKey(0), **kw, risk=(
        J.RiskConfig(n_draws=32, quantile=0.9) if risk else None))
    got = T.portfolio_search(tsp, _tkey(0), **kw, risk=(
        T.RiskConfig(n_draws=32, quantile=0.9) if risk else None),
        device="cpu")
    _history_same(want, got)
    assert got.best.label == want.best.label
    assert got.n_evaluated == want.n_evaluated
    assert [r.label for r in got.ranked] == [r.label for r in want.ranked]
    assert got.objective_key == want.objective_key
    close(want.best.objective(want.objective_key),
          got.best.objective(got.objective_key), rtol=ENGINE_RTOL)
    assert [p["label"] for p in got.pareto] == \
        [p["label"] for p in want.pareto]
    # a JAX key is taken as it is
    again = T.portfolio_search(tsp, jax.random.PRNGKey(0), **kw, risk=(
        T.RiskConfig(n_draws=32, quantile=0.9) if risk else None),
        device="cpu")
    assert again.history == got.history


def test_report_rows_and_json_match_jax():
    jsp, tsp = _three(J), _three(T)
    kw = dict(population=16, generations=4, elite=4)
    want = J.portfolio_search(jsp, jax.random.PRNGKey(1), **kw,
                              risk=J.RiskConfig(n_draws=32))
    got = T.portfolio_search(tsp, _tkey(1), **kw,
                             risk=T.RiskConfig(n_draws=32), device="cpu")
    rows_w, rows_g = J.result_rows(want.top(5)), T.result_rows(got.top(5))
    sum_w, sum_g = J.search_summary(want), T.search_summary(got)
    import json
    assert list(json.loads(T.to_json(sum_g))) == list(sum_w)
    assert sum_g["best"]["candidate"] == sum_w["best"]["candidate"]
    for rw, rg in zip(rows_w + J.detail_rows(jsp, want.best.candidate),
                      rows_g + T.detail_rows(tsp, got.best.candidate,
                                             device="cpu")):
        assert list(rg) == list(rw)
        for k, v in rw.items():
            if isinstance(v, (str, bool)):
                assert rg[k] == v, k
            else:
                close(v, rg[k], rtol=ENGINE_RTOL, atol=1e-6, what=k)
    assert T.format_table(rows_g).splitlines()[0] == \
        J.format_table(rows_w).splitlines()[0]


def test_dse_bench_space_prices_like_jax():
    """All 19,707 candidates of dse_bench's space (59,121 systems) in
    chunks of 512: every field at 1e-5 and the same exhaustive winner."""
    jsp, tsp = _bench(J), _bench(T)
    idx = np.arange(tsp.size())
    want = J.ChunkedEvaluator(jsp, candidates_per_chunk=512) \
        .evaluate_indices(idx)
    got = T.ChunkedEvaluator(tsp, candidates_per_chunk=512, device="cpu") \
        .evaluate_indices(idx)
    _arrays_close(want, got, "dse_bench")
    assert got.portfolio_cost.argmin() == want.portfolio_cost.argmin()


# -- one device-to-host copy ----------------------------------------------

class _CountCopies:
    """Counts ``Tensor.cpu``/``item``/``tolist`` calls while active."""

    def __init__(self, monkeypatch):
        self.n = 0
        for name in ("cpu", "item", "tolist"):
            orig = getattr(torch.Tensor, name)

            def counted(t, *a, _orig=orig, **k):
                self.n += 1
                return _orig(t, *a, **k)
            monkeypatch.setattr(torch.Tensor, name, counted)


@pytest.mark.parametrize("mc", [False, True])
def test_a_sweep_reads_back_once(monkeypatch, mc):
    sp = _space(T)
    ev = T.ChunkedEvaluator(sp, candidates_per_chunk=8, device="cpu")
    kw = dict(mc_key=_tkey(3), mc_draws=16) if mc else {}
    want = ev.evaluate_indices(np.arange(sp.size()), **kw)
    count = _CountCopies(monkeypatch)
    got = ev.evaluate_indices(np.arange(sp.size()), **kw)
    assert count.n == 1, f"{count.n} reads for {ev.n_chunks} chunks"
    equal(want.portfolio_cost, got.portfolio_cost, what="rerun")


def test_a_search_reads_back_once_a_generation(monkeypatch):
    sp = _three(T)
    key = _tkey(2)
    count = _CountCopies(monkeypatch)
    res = T.portfolio_search(sp, key, population=12, generations=5,
                             elite=3, risk=T.RiskConfig(n_draws=16),
                             device="cpu")
    assert len(res.history) == 5
    assert count.n == 5 + 1, count.n        # the final sweep reads once


def test_portfolio_search_entry_point_on_the_cpu(capsys):
    launch.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "design space: 2752 candidate" in out
    assert "search found the exact optimum" in out
    assert "risk-aware winner (q90 objective): reuse[150mm2/7nm/MCM]" in out


def test_results_are_host_arrays():
    sp = _space(T)
    arrays = T.ChunkedEvaluator(sp, device="cpu").evaluate_indices(
        np.arange(5))
    for f in ("sku_unit_total", "portfolio_cost", "finite"):
        assert isinstance(getattr(arrays, f), np.ndarray)
    assert arrays.sku_unit_total.dtype == np.float32
    assert arrays.finite.dtype == bool and arrays.finite.all()
    assert to_numpy(arrays.portfolio_cost).shape == (5,)
