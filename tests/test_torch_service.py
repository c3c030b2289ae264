"""The port's pricing service (repro_torch.service) on the CPU, held two
ways.

* Against the port's own direct APIs, bit for bit: coalesced price,
  Monte Carlo, rank, what-if and search responses equal
  ``ChunkedEvaluator(space, candidates_per_chunk=cfg.chunk)`` and
  ``portfolio_search`` (with that evaluator) with ``array_equal``.  Each
  row's price depends only on its own row for a fixed chunk shape, so
  coalescing changes which rows share a tick, never the rows.
* Against the JAX service on the same seeded request script: prices,
  Monte Carlo stats and what-if grids at ``ENGINE_RTOL`` (1e-5); the same
  search histories and winners and the same rank orders; the same error
  codes; the same ticks by lane from the same arrival order.

Plus the tick's discipline: one device-to-host copy a tick
(``device_gets == ticks``), no host read before it, no lane signature
first run on the tick loop, bills summing to the tick wall, and the
reference's snapshot keys.
"""
import asyncio
import dataclasses

import numpy as np
import pytest
import torch

import repro.dse as JD
import repro.service as JS
import repro_torch.dse as TD
import repro_torch.service as TS
from repro_torch import random as prng
from repro_torch.core import CostEngine, SystemBatch
from repro_torch.core.system import spec
from repro_torch.obs import torchhooks
from repro_torch.service import server as tserver
from torch_parity import ENGINE_RTOL, close

DEV = "cpu"


def _space(D):
    return D.DesignSpace(
        skus=(D.SKU("laptop", 200.0, 2e6), D.SKU("server", 400.0, 5e5)),
        processes=("7nm", "12nm"), integrations=("MCM",),
        chiplet_counts=(1, 2, 4), allow_reuse=True)


@pytest.fixture(scope="module")
def space():
    return _space(TD)


@pytest.fixture(scope="module")
def jspace():
    return _space(JD)


@pytest.fixture(scope="module")
def evaluator(space):
    # the service's chunk shape: the direct path runs the same probes at
    # the same shapes
    return TD.ChunkedEvaluator(space, candidates_per_chunk=16, device=DEV)


@pytest.fixture(autouse=True)
def _no_env_faults(monkeypatch):
    monkeypatch.delenv("REPRO_FAULTS", raising=False)


def _cfg(S, **kw):
    return S.ServiceConfig(chunk=16, split=4, warm_mc=((64, (0.5, 0.9)),),
                           **kw)


CFG = _cfg(TS)


def _arrays_equal(a, b):
    assert np.array_equal(a.idx, b.idx)
    assert np.array_equal(a.sku_unit_total, b.sku_unit_total)
    assert np.array_equal(a.sku_unit_re, b.sku_unit_re)
    assert np.array_equal(a.sku_unit_nre, b.sku_unit_nre)
    assert np.array_equal(a.portfolio_cost, b.portfolio_cost)
    if a.risk is None:
        assert b.risk is None
    else:
        assert set(a.risk) == set(b.risk)
        for k in a.risk:
            assert np.array_equal(a.risk[k], b.risk[k]), k


def _search_equal(got, want):
    assert got.best.label == want.best.label
    assert got.best.portfolio_cost == want.best.portfolio_cost
    assert got.history == want.history
    assert [r.label for r in got.ranked] == [r.label for r in want.ranked]
    assert [r.portfolio_cost for r in got.ranked] == \
        [r.portfolio_cost for r in want.ranked]
    assert [r.risk for r in got.ranked] == [r.risk for r in want.ranked]


# ---------------------------------------------------------------------------
# Oracle 1: the port's service against the port's direct APIs, bit for bit
# ---------------------------------------------------------------------------


def test_mixed_workload_bit_exact_against_direct_apis(space, evaluator):
    mc = TS.McSpec(draws=64, quantiles=(0.5, 0.9), seed=7)
    reqs = [
        TS.PriceRequest(indices=[0, 3, 5, 7, 9]),
        TS.PriceRequest(indices=list(range(space.size()))),
        TS.MCRiskRequest(indices=[1, 2, 3, 8], mc=mc),
        TS.RankRequest(indices=list(range(0, space.size(), 2)), top_k=4),
        TS.SearchRequest(seed=3, population=8, generations=4, elite=3),
        TS.PriceRequest(indices=[11, 2, 11], mc=mc),
    ]
    resps, svc = TS.serve(space, reqs, CFG, device=DEV)
    assert all(r.ok for r in resps), [r.error for r in resps]
    _arrays_equal(resps[0].result,
                  evaluator.evaluate_indices(np.asarray([0, 3, 5, 7, 9])))
    _arrays_equal(resps[1].result,
                  evaluator.evaluate_indices(np.arange(space.size())))
    mc_kw = dict(mc_key=prng.PRNGKey(7, DEV), mc_draws=64,
                 mc_quantiles=(0.5, 0.9))
    _arrays_equal(resps[2].result, evaluator.evaluate_indices(
        np.asarray([1, 2, 3, 8]), **mc_kw))
    _arrays_equal(resps[5].result, evaluator.evaluate_indices(
        np.asarray([11, 2, 11]), **mc_kw))
    direct = evaluator.evaluate_indices(np.arange(0, space.size(), 2))
    order = np.lexsort((direct.idx, direct.portfolio_cost))
    rk = resps[3].result
    assert np.array_equal(rk.order, direct.idx[order])
    assert np.array_equal(rk.values, direct.portfolio_cost[order])
    assert [r.label for r in rk.top] == [
        space.candidate_at(int(i)).label() for i in direct.idx[order[:4]]]
    ds = TD.portfolio_search(space, prng.PRNGKey(3, DEV), population=8,
                             generations=4, elite=3, evaluator=evaluator)
    _search_equal(resps[4].result, ds)
    snap = svc.snapshot()
    assert snap["device_gets"] == snap["ticks"]
    assert snap["n_ok"] == len(reqs)
    assert snap["recompiles_after_warmup"] == 0


def test_risk_search_bit_exact_against_portfolio_search(space, evaluator):
    risk = TD.RiskConfig(n_draws=32, quantile=0.9,
                         sigmas=TD.Uncertainty(defect_sigma=0.3))
    resps, _ = TS.serve(space, [TS.SearchRequest(
        seed=11, population=8, generations=3, elite=2, risk=risk)], CFG,
        device=DEV)
    assert resps[0].ok, resps[0].error
    ds = TD.portfolio_search(space, prng.PRNGKey(11, DEV), population=8,
                             generations=3, elite=2, risk=risk,
                             evaluator=evaluator)
    assert resps[0].result.objective_key == "q90" == ds.objective_key
    _search_equal(resps[0].result, ds)


def test_what_if_bit_exact_and_skips(space, evaluator):
    req = TS.WhatIfRequest(base=5, processes=("7nm", "12nm"),
                           integrations=("MCM", "2.5D"))
    resps, _ = TS.serve(space, [req], CFG, device=DEV)
    assert resps[0].ok, resps[0].error
    wi = resps[0].result
    assert wi.base_label == space.candidate_at(5).label()
    assert wi.base_cost == float(
        evaluator.evaluate_indices(np.asarray([5])).portfolio_cost[0])
    labels = {space.candidate_at(i).label(): i for i in range(space.size())}
    for row in wi.rows:
        direct = float(evaluator.evaluate_indices(
            np.asarray([labels[row["candidate"]]])).portfolio_cost[0])
        assert row["portfolio_cost"] == direct
        assert row["delta_vs_base"] == row["portfolio_cost"] - wi.base_cost
    assert ("7nm", "2.5D") in {(s["process"], s["integration"])
                               for s in wi.skipped}


def test_raw_systems_lane_prices_like_the_engine(space):
    specs = (
        {"kind": "soc", "name": "a", "area": 150.0, "process": "7nm",
         "quantity": 1e6},
        {"kind": "split", "name": "b", "area": 300.0, "process": "7nm",
         "n_chiplets": 2, "integration": "MCM", "quantity": 5e5},
    )
    resps, _ = TS.serve(space, [TS.PriceSystemsRequest(specs=specs)], CFG,
                        device=DEV)
    assert resps[0].ok, resps[0].error
    systems = [spec(dict(d)) for d in specs]
    tot = CostEngine().total(SystemBatch.from_systems(
        systems, share_nre=[0, 0], device=DEV))
    for i, row in enumerate(resps[0].result.rows):
        assert row["system"] == systems[i].name
        np.testing.assert_allclose(row["total"], float(tot.total[i]),
                                   rtol=1e-6)


def test_interleaving_determinism(space):
    base_reqs = [
        TS.PriceRequest(indices=[0, 1, 2, 3, 4, 5, 6, 7]),
        TS.MCRiskRequest(indices=[2, 4, 6], mc=TS.McSpec(draws=64, seed=5)),
        TS.RankRequest(indices=[9, 1, 5, 3], top_k=2),
        TS.SearchRequest(seed=2, population=8, generations=3, elite=2),
        TS.PriceRequest(indices=[7, 7, 1]),
    ]
    cfg = dataclasses.replace(CFG, result_cache_entries=0)

    def run(order_seed):
        rng = np.random.default_rng(order_seed)
        order = rng.permutation(len(base_reqs))

        async def _main():
            svc = TS.PricingService(space, cfg, device=DEV)
            await svc.start()

            async def client(j):
                await asyncio.sleep(float(rng.integers(0, 4)) * 1e-3)
                return j, await svc.submit(base_reqs[j])

            pairs = await asyncio.gather(*(client(int(j)) for j in order))
            await svc.stop()
            return dict(pairs)

        return asyncio.run(_main())

    runs = [run(s) for s in (0, 1, 2)]
    for other in runs[1:]:
        for j, req in enumerate(base_reqs):
            a, b = runs[0][j], other[j]
            assert a.ok and b.ok
            if req.kind in ("price", "mc_risk"):
                _arrays_equal(a.result, b.result)
            elif req.kind == "rank":
                assert np.array_equal(a.result.order, b.result.order)
                assert np.array_equal(a.result.values, b.result.values)
            else:
                assert a.result.history == b.result.history
                assert [r.label for r in a.result.ranked] == \
                    [r.label for r in b.result.ranked]


def test_error_envelope_isolation(space, evaluator, monkeypatch):
    orig = tserver.PricingService._rank_payload

    def poisoned(self, arrays, objective, top_k):
        if top_k == 13:
            raise RuntimeError("poisoned request")
        return orig(self, arrays, objective, top_k)

    monkeypatch.setattr(tserver.PricingService, "_rank_payload", poisoned)
    reqs = [TS.PriceRequest(indices=[0, 1, 2, 3]),
            TS.RankRequest(indices=[4, 5, 6], top_k=13),
            TS.MCRiskRequest(indices=[7, 8], mc=TS.McSpec(draws=64, seed=1))]
    resps, svc = TS.serve(space, reqs, CFG, device=DEV)
    assert resps[0].ok and resps[2].ok and not resps[1].ok
    assert resps[1].error.code == "internal"
    _arrays_equal(resps[0].result,
                  evaluator.evaluate_indices(np.asarray([0, 1, 2, 3])))
    assert svc.snapshot()["n_errors"] == 1
    assert svc.log.records(event="error")


def test_result_cache_hit(space, evaluator):
    async def _main():
        svc = TS.PricingService(space, CFG, device=DEV)
        await svc.start()
        r1 = await svc.submit(TS.PriceRequest(indices=[1, 3, 5]))
        ticks = svc.metrics.ticks
        r2 = await svc.submit(TS.PriceRequest(indices=[1, 3, 5]))
        r3 = await svc.submit(TS.PriceRequest(indices=[5, 3, 1]))
        await svc.stop()
        return svc, r1, ticks, r2, r3

    svc, r1, ticks, r2, r3 = asyncio.run(_main())
    assert not r1.cached and r2.cached and not r3.cached
    assert svc.metrics.ticks > ticks
    _arrays_equal(r1.result, r2.result)
    _arrays_equal(r3.result,
                  evaluator.evaluate_indices(np.asarray([5, 3, 1])))
    assert svc.snapshot()["result_cache"]["hits"] == 1


def test_point_query_not_starved_by_sweep(space):
    cfg = dataclasses.replace(CFG, chunk=8, split=2)
    done_order = []

    async def _main():
        svc = TS.PricingService(space, cfg, device=DEV)
        await svc.start()

        async def client(tag, req):
            r = await svc.submit(req)
            done_order.append(tag)
            return r

        big, point = await asyncio.gather(
            client("big", TS.PriceRequest(
                indices=list(range(space.size())) * 3)),
            client("point", TS.PriceRequest(indices=[7])))
        await svc.stop()
        return big, point

    big, point = asyncio.run(_main())
    assert big.ok and point.ok
    assert done_order[0] == "point"


def test_backpressure_queue_full(space):
    cfg = dataclasses.replace(CFG, max_pending=space.size() + 4)

    async def _main():
        svc = TS.PricingService(space, cfg, device=DEV)
        await svc.start()
        big = asyncio.ensure_future(svc.submit(
            TS.PriceRequest(indices=list(range(space.size())))))
        await asyncio.sleep(0)
        burst = await svc.submit(TS.PriceRequest(indices=[0, 1, 2, 3, 4, 5]))
        r_big = await big
        retry = await svc.submit(TS.PriceRequest(indices=[0, 1, 2, 3, 4, 5]))
        await svc.stop()
        return burst, r_big, retry, svc

    burst, r_big, retry, svc = asyncio.run(_main())
    assert not burst.ok and burst.error.code == TS.QUEUE_FULL
    assert r_big.ok and retry.ok
    assert svc.snapshot()["n_rejected"] == 1


def test_no_first_call_after_warmup(space):
    """After start() warms the configured lanes, a mixed workload makes
    no probe's first call of a signature (the port's "no recompile")."""

    async def _main():
        svc = TS.PricingService(space, dataclasses.replace(
            CFG, warm_search=(TS.SearchWarmup(population=8, elite=2),)),
            device=DEV)
        await svc.start()
        before = torchhooks.total_compiles()
        reqs = [
            TS.PriceRequest(indices=[0, 1, 2]),
            TS.MCRiskRequest(indices=[3, 4], mc=TS.McSpec(draws=64, seed=9)),
            TS.RankRequest(indices=list(range(10)), top_k=3),
            TS.WhatIfRequest(base=2),
            TS.SearchRequest(seed=4, population=8, generations=2, elite=2),
            TS.PriceSystemsRequest(specs=(
                {"kind": "soc", "name": "s", "area": 120.0,
                 "process": "7nm", "quantity": 1e6},)),
        ]
        resps = await asyncio.gather(*(svc.submit(r) for r in reqs))
        await svc.stop()
        return svc, before, torchhooks.total_compiles(), resps

    svc, before, after, resps = asyncio.run(_main())
    assert all(r.ok for r in resps), [r.error for r in resps]
    assert after == before
    assert svc.snapshot()["recompiles_after_warmup"] == 0


def test_service_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    sp = _space(TD)
    with pytest.raises(RuntimeError, match="GPU"):
        TS.PricingService(sp, CFG)
    with pytest.raises(RuntimeError, match="GPU"):
        TS.serve(sp, [TS.PriceRequest(indices=[0])], CFG)


# ---------------------------------------------------------------------------
# The tick's discipline
# ---------------------------------------------------------------------------


def test_tick_reads_nothing_back_before_its_one_copy(space, monkeypatch):
    """Count ``.cpu()``, ``.numpy()``, ``.item()`` and ``.tolist()`` of
    tensors inside every tick: none after the tick's first upload and
    before its copy (reads before the first upload are the raw lane's
    host staging, which never touched the device), and exactly one copy
    a tick."""
    events = []
    active = [False]
    real_to_host = torchhooks.to_host
    real_upload = tserver.upload

    def spy(name):
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, **k):
            if active[0]:
                events.append(name)
            return orig(self, *a, **k)
        return wrapped

    def to_host(tree):
        events.append("COPY")
        was, active[0] = active[0], False
        try:
            return real_to_host(tree)
        finally:
            active[0] = was

    def upload(host, device, dtype=None):
        events.append("UPLOAD")
        return real_upload(host, device, dtype)

    for name in ("cpu", "numpy", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, spy(name))
    monkeypatch.setattr(torchhooks, "to_host", to_host)
    monkeypatch.setattr(tserver, "upload", upload)
    real_tick = tserver.PricingService._tick

    def tick(self):
        events.append("TICK")
        active[0] = True
        try:
            return real_tick(self)
        finally:
            active[0] = False
            events.append("END")

    monkeypatch.setattr(tserver.PricingService, "_tick", tick)
    reqs = [TS.PriceRequest(indices=list(range(20))),
            TS.MCRiskRequest(indices=[1, 2], mc=TS.McSpec(draws=64, seed=3)),
            TS.SearchRequest(seed=1, population=8, generations=2, elite=2),
            TS.WhatIfRequest(base=3),
            TS.PriceSystemsRequest(specs=(
                {"kind": "soc", "name": "s", "area": 120.0,
                 "process": "7nm", "quantity": 1e6},))]
    resps, svc = TS.serve(space, reqs, CFG, device=DEV)
    assert all(r.ok for r in resps), [r.error for r in resps]
    ticks, cur = [], None
    for e in events:
        if e == "TICK":
            cur = []
        elif e == "END":
            ticks.append(cur)
            cur = None
        elif cur is not None:
            cur.append(e)
    assert len(ticks) == svc.snapshot()["ticks"]
    for t in ticks:
        assert t.count("COPY") == 1, t
        before_copy = t[:t.index("COPY")]
        # without an upload (the search lane's state lives on the device)
        # nothing at all may be read before the copy
        first_up = before_copy.index("UPLOAD") if "UPLOAD" in before_copy \
            else 0
        assert set(before_copy[first_up:]) <= {"UPLOAD"}, t


@pytest.fixture(scope="module")
def served(space, jspace):
    """The seeded script of every kind, served by both packages."""
    tresps, tsvc = TS.serve(space, _script(TS, TD, space.size()), _cfg(TS),
                            device=DEV)
    jresps, jsvc = JS.serve(jspace, _script(JS, JD, jspace.size()),
                            _cfg(JS))
    return tresps, tsvc, jresps, jsvc


def test_bills_sum_to_tick_wall_and_snapshot_keys_match_reference(served):
    tresps, tsvc, jresps, jsvc = served
    ok = [r for r in tresps if r.ok]
    assert ok and all(r.trace_id and r.bill and r.bill["status"] != "open"
                      for r in tresps)
    led = tsvc.snapshot()["ledger"]
    assert led["open"] == 0
    assert led["tick_residual_rel_max"] <= 0.05
    assert led["unattributed_ms"] == 0.0
    billed = sum(r.bill["device_ms"] for r in tresps)
    assert billed == pytest.approx(led["device_ms_total"], rel=0.05)
    assert led["device_ms_total"] == pytest.approx(
        tsvc.snapshot()["busy_s"] * 1e3, rel=0.05)

    def keys(d, depth=0):
        out = set()
        for k, v in d.items():
            out.add(k)
            if isinstance(v, dict) and depth < 1 and k not in (
                    "per_lane", "ticks_by_lane", "requests_by_kind",
                    "trace", "by_kind", "by_lane", "fired", "checked"):
                out |= {f"{k}.{kk}" for kk in keys(v, depth + 1)}
        return out

    assert keys(tsvc.snapshot()) == keys(jsvc.snapshot())


# ---------------------------------------------------------------------------
# Oracle 2: the port's service against the JAX service, same script
# ---------------------------------------------------------------------------


def _script(S, D, size):
    """A seeded request script with every kind, valid and invalid."""
    rng = np.random.default_rng(5)
    mc = S.McSpec(draws=64, quantiles=(0.5, 0.9), seed=3,
                  sigmas=D.Uncertainty(defect_sigma=0.2, bond_sigma=0.1))
    reqs = []
    for i in range(4):
        reqs.append(S.PriceRequest(
            indices=rng.integers(0, size, 24).tolist()))
        reqs.append(S.PriceRequest(indices=rng.integers(0, size, 3).tolist()))
    reqs += [
        S.MCRiskRequest(indices=rng.integers(0, size, 10).tolist(), mc=mc),
        S.PriceRequest(indices=rng.integers(0, size, 5).tolist(), mc=mc),
        S.RankRequest(indices=rng.integers(0, size, 30).tolist(), top_k=6),
        S.RankRequest(indices=None, top_k=5, mc=mc, objective="q90"),
        S.WhatIfRequest(base=int(rng.integers(0, size))),
        S.WhatIfRequest(base=4, processes=("7nm",),
                        integrations=("MCM", "2.5D")),
        S.SearchRequest(seed=5, population=8, generations=3, elite=2),
        S.SearchRequest(seed=6, population=8, generations=2, elite=3,
                        risk=D.RiskConfig(n_draws=32, quantile=0.9)),
        S.PriceSystemsRequest(specs=(
            {"kind": "soc", "name": "a", "area": 150.0, "process": "7nm",
             "quantity": 1e6},
            {"kind": "split", "name": "b", "area": 300.0, "process": "7nm",
             "n_chiplets": 2, "integration": "MCM", "quantity": 5e5},)),
        # invalid and oversize requests
        S.PriceRequest(indices=[0, size + 7]),
        S.PriceRequest(),
        S.RankRequest(indices=[1], objective="q90"),
        S.SearchRequest(population=4, elite=9),
        S.PriceSystemsRequest(specs=({"kind": "nope", "name": "x"},)),
        S.PriceRequest(indices=[1], flow="no-such-flow"),
        S.PriceSystemsRequest(specs=()),
        S.PriceSystemsRequest(specs=tuple(
            {"kind": "soc", "name": f"s{i}", "area": 100.0,
             "process": "7nm", "quantity": 1.0} for i in range(17))),
        S.MCRiskRequest(indices=[1], mc=S.McSpec(sigmas=D.Uncertainty(
            defect_sigma=float("nan")))),
        S.PriceRequest(indices=[1], deadline_ms=-1.0),
    ]
    return reqs


def _compare(jr, tr):
    assert tr.ok == jr.ok, (tr.error, jr.error)
    assert tr.kind == jr.kind
    if not jr.ok:
        assert tr.error.code == jr.error.code
        return
    j, t = jr.result, tr.result
    if jr.kind in ("price", "mc_risk"):
        assert np.array_equal(t.idx, j.idx)
        for f in ("sku_unit_total", "sku_unit_re", "sku_unit_nre",
                  "portfolio_cost"):
            close(getattr(j, f), getattr(t, f), rtol=ENGINE_RTOL, what=f)
        assert (t.risk is None) == (j.risk is None)
        for k in (j.risk or {}):
            close(j.risk[k], t.risk[k], rtol=ENGINE_RTOL, what=k)
    elif jr.kind == "rank":
        close(j.values, t.values, rtol=ENGINE_RTOL, what="rank values")
        if not np.array_equal(t.order, j.order):
            print("rank order differs on a near-tie:",
                  j.values[:10], t.values[:10])
        assert np.array_equal(t.order, j.order)
        assert [r.label for r in t.top] == [r.label for r in j.top]
    elif jr.kind == "what_if":
        assert t.base_label == j.base_label and t.skipped == j.skipped
        close(j.base_cost, t.base_cost, rtol=ENGINE_RTOL)
        assert [r["candidate"] for r in t.rows] == \
            [r["candidate"] for r in j.rows]
        close([r["portfolio_cost"] for r in j.rows],
              [r["portfolio_cost"] for r in t.rows], rtol=ENGINE_RTOL)
    elif jr.kind == "search":
        if t.best.label != j.best.label:
            print("search winners differ:", j.best.label,
                  j.best.portfolio_cost, t.best.label,
                  t.best.portfolio_cost)
        assert t.best.label == j.best.label
        assert [h["best_label"] for h in t.history] == \
            [h["best_label"] for h in j.history]
        assert [h["evaluated"] for h in t.history] == \
            [h["evaluated"] for h in j.history]
        close([h["best_objective"] for h in j.history],
              [h["best_objective"] for h in t.history], rtol=ENGINE_RTOL)
        assert [r.label for r in t.ranked] == [r.label for r in j.ranked]
        assert t.objective_key == j.objective_key
    else:
        assert [r["system"] for r in t.rows] == [r["system"] for r in j.rows]
        for key in ("re_total", "nre_total", "total"):
            close([r[key] for r in j.rows], [r[key] for r in t.rows],
                  rtol=ENGINE_RTOL, what=key)


def test_service_against_the_jax_service_on_one_script(served):
    tresps, tsvc, jresps, jsvc = served
    assert len(tresps) == len(jresps)
    assert sum(not r.ok for r in jresps) == 10
    for jr, tr in zip(jresps, tresps):
        _compare(jr, tr)
    ts, js = tsvc.snapshot(), jsvc.snapshot()
    assert ts["ticks_by_lane"] == js["ticks_by_lane"]
    for key in ("ticks", "device_gets", "n_ok", "n_errors", "rows_priced",
                "slots_used", "slot_occupancy"):
        if key in js:
            assert ts[key] == js[key], key
    assert ts["recompiles_after_warmup"] == 0


def test_error_codes_for_deadline_and_queue_full_match_the_jax_service(
        space, jspace):
    def run(S, sp, **kw):
        cfg = dataclasses.replace(_cfg(S), max_pending=sp.size() + 4)

        async def _main():
            svc = S.PricingService(sp, cfg, **kw)
            doomed = asyncio.ensure_future(svc.submit(
                S.PriceRequest(indices=[0, 1, 2], deadline_ms=5.0)))
            await asyncio.sleep(0.03)
            await svc.start()
            big = asyncio.ensure_future(svc.submit(
                S.PriceRequest(indices=list(range(sp.size())))))
            await asyncio.sleep(0)
            burst = await svc.submit(S.PriceRequest(indices=[0, 1, 2, 3, 4]))
            out = [await doomed, burst, await big]
            await svc.stop()
            out.append(await svc.submit(S.PriceRequest(indices=[1])))
            return out

        return [(r.ok, r.error.code if r.error else None)
                for r in asyncio.run(_main())]

    want = run(JS, jspace)
    assert want == [(False, "deadline_exceeded"), (False, "queue_full"),
                    (True, None), (False, "shutting_down")]
    assert run(TS, space, device=DEV) == want


# ---------------------------------------------------------------------------
# The scheduler: the same tick plans as the reference's
# ---------------------------------------------------------------------------


def _plans(S, seed):
    rng = np.random.default_rng(seed)
    sched = S.Scheduler(slots=8, split=3, raw_slots=4, max_pending=400)
    lanes = [S.Lane(kind="chunk"), S.Lane(kind="chunk", flow="chip-first"),
             S.Lane(kind="mc", mc=(64, (0.5,), (0, 1), (0.1, 0.1, 0.1, 0.1))),
             S.Lane(kind="raw"), S.Lane(kind="gen")]
    items, trace = [], []
    for step in range(60):
        if rng.random() < 0.6:
            lane = lanes[int(rng.integers(0, len(lanes)))]
            tag = len(items)
            if lane.kind == "raw":
                w = S.GroupWork(owner=tag, lane=lane,
                                systems=[0] * int(rng.integers(1, 4)))
                cost = w.n_systems
            elif lane.kind == "gen":
                w = S.GenWork(owner=tag, lane=lane, task=None)
                cost = 8
            else:
                n = int(rng.integers(1, 20))
                w = S.SpanWork(owner=tag, lane=lane,
                               idx=np.arange(n, dtype=np.int64) + 100 * tag)
                cost = n
            items.append(w)
            trace.append(("admit", tag, sched.admit([w], cost)))
        plan = sched.plan()
        if plan is None:
            trace.append(None)
            continue
        trace.append((plan.lane.kind, plan.lane.flow, plan.slots, plan.used,
                      [(a.item.owner, a.start, a.n, a.slot)
                       for a in plan.assignments],
                      [g.owner for g in plan.groups],
                      plan.gen.owner if plan.gen else None,
                      sched.pending_rows))
        sched.release(plan.used)
    return trace


@pytest.mark.parametrize("seed", range(4))
def test_scheduler_plans_equal_the_reference(seed):
    assert _plans(TS, seed) == _plans(JS, seed)


def test_service_exports_mirror_the_reference():
    assert sorted(TS.__all__) == sorted(JS.__all__)
    j = {f.name for f in dataclasses.fields(JS.ServiceConfig)}
    t = {f.name for f in dataclasses.fields(TS.ServiceConfig)}
    assert t == j
