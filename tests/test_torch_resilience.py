"""The port's failure handling (repro_torch.resilience and the hardened
service) against the JAX package's, on the CPU.

The building blocks are copies, so the same inputs must give the same
traces: fault specs parse alike and fire on the same checks, the retry
and breaker state machines step alike, and the non-finite walker names
the same paths (tensors included).  Through the port's service, a seeded
chaos schedule gives typed envelopes and ok rows bit-exact against the
oracle their provenance mask names, and disabled faults move no counter.
"""
import asyncio
import dataclasses
import time

import numpy as np
import pytest
import torch

import repro.dse as JD
import repro.resilience as JR
import repro.service as JS
import repro_torch.dse as TD
import repro_torch.resilience as TR
import repro_torch.service as TS
from repro_torch import random as prng

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
def evaluator(space):
    return TD.ChunkedEvaluator(space, candidates_per_chunk=16, device=DEV)


@pytest.fixture(scope="module")
def oracle(space):
    return TD.ChunkedEvaluator(space, candidates_per_chunk=16, fused=False,
                               device=DEV)


@pytest.fixture(autouse=True)
def _no_env_faults(monkeypatch):
    monkeypatch.delenv("REPRO_FAULTS", raising=False)


CFG = TS.ServiceConfig(chunk=16, split=4, warm_mc=((64, (0.5, 0.9)),))


def _run(coro):
    return asyncio.run(coro)


# ---------------------------------------------------------------------------
# Fault injection: the same grammar and the same schedule as the reference
# ---------------------------------------------------------------------------

SPECS = [
    "seed=42; dispatch_error:p=0.3 ;stall:p=1.0,ms=1500,n=1",
    "seed=13;dispatch_error:p=0.4;poison:p=0.35,n=2;flood:p=0.25,n=2;"
    "recompile:p=0.5,n=1",
    "seed=1;crash:p=0.3,n=1",
    "poison:p=0.0",
    "seed=7",
    "",
]
BAD_SPECS = ["explode:p=1.0", "stall:ms=5", "poison:p=1.5",
             "poison:p=0.5,zap=1", "seed=x"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_spec_parses_as_the_reference(spec):
    assert TR.parse_fault_spec(spec) == tuple(
        (s if i == 0 else {k: TR.FaultRule(**dataclasses.asdict(r))
                           for k, r in s.items()})
        for i, s in enumerate(JR.parse_fault_spec(spec)))
    assert bool(TR.FaultInjector(spec)) == bool(JR.FaultInjector(spec))
    assert TR.FAULT_KINDS == JR.FAULT_KINDS


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_fault_specs_fail_as_in_the_reference(spec):
    with pytest.raises(ValueError):
        JR.parse_fault_spec(spec)
    with pytest.raises(ValueError):
        TR.parse_fault_spec(spec)


@pytest.mark.parametrize("spec", SPECS[:4])
def test_fault_fire_schedule_equals_the_reference(spec):
    """Every kind checked in a seeded interleaving fires on the same
    checks in both packages, with the same payload streams and stats."""
    j, t = JR.FaultInjector(spec), TR.FaultInjector(spec)
    order = np.random.default_rng(0).choice(len(JR.FAULT_KINDS), 300)
    fired_j, fired_t = [], []
    for i in order:
        kind = JR.FAULT_KINDS[i]
        fired_j.append(j.fire(kind) is not None)
        fired_t.append(t.fire(kind) is not None)
    assert fired_j == fired_t
    assert j.stats() == t.stats()
    for n in range(5):
        assert j.rng("poison", n).randrange(1000) == \
            t.rng("poison", n).randrange(1000)


# ---------------------------------------------------------------------------
# Retry + circuit breaker: the same state traces
# ---------------------------------------------------------------------------


def _retry_trace(R, fail_first: int, retries: int):
    calls, slept, seen = [], [], []

    def flaky():
        calls.append(1)
        if len(calls) <= fail_first:
            raise RuntimeError("boom")
        return "ok"

    try:
        out = R.call_with_retry(flaky, R.RetryPolicy(retries=retries,
                                                     backoff_s=0.01),
                                on_retry=lambda n, e: seen.append(n),
                                sleep=slept.append)
    except RuntimeError as e:
        out = f"raised {e}"
    return out, len(calls), slept, seen


@pytest.mark.parametrize("fail_first,retries", [(0, 1), (2, 2), (3, 2),
                                                (1, 0)])
def test_call_with_retry_trace_equals_the_reference(fail_first, retries):
    assert _retry_trace(TR, fail_first, retries) == \
        _retry_trace(JR, fail_first, retries)


def _breaker_trace(R):
    t = [0.0]
    events, trace = [], []
    br = R.CircuitBreaker(threshold=2, cooldown_s=1.0, clock=lambda: t[0],
                          on_event=events.append)
    script = [(0.0, "allow"), (0.0, "fail"), (0.0, "allow"), (0.0, "fail"),
              (0.5, "allow"), (1.1, "allow"), (1.1, "fail"), (1.5, "allow"),
              (2.2, "allow"), (2.2, "ok"), (2.3, "allow"), (2.4, "fail"),
              (2.5, "fail"), (3.6, "allow"), (3.6, "ok")]
    for at, op in script:
        t[0] = at
        if op == "allow":
            trace.append(br.allow())
        elif op == "fail":
            br.record_failure()
        else:
            br.record_success()
        trace.append(br.snapshot())
    return events, trace


def test_circuit_breaker_trace_equals_the_reference():
    assert _breaker_trace(TR) == _breaker_trace(JR)


def test_watchdog_one_trip_per_stall():
    stalls = []
    wd = TR.Watchdog(timeout_s=0.05, on_stall=stalls.append, poll_s=0.01)
    wd.start()
    try:
        wd.enter()
        time.sleep(0.15)                   # one stuck "tick"
        assert wd.trips == 1               # latched: not once per poll
        assert len(stalls) == 1 and stalls[0] >= 0.05
        wd.exit()
        time.sleep(0.05)
        assert wd.trips == 1               # idle: no trips
        wd.enter()
        wd.exit()                          # fast tick: no trip
        time.sleep(0.03)
        assert wd.trips == 1
    finally:
        wd.stop()
    assert not wd.snapshot()["running"]
    with pytest.raises(ValueError):
        TR.Watchdog(0.0, stalls.append)


# ---------------------------------------------------------------------------
# Numerical guardrails: the same problem lists
# ---------------------------------------------------------------------------


def _nan_requests(S, D, arr):
    nan, inf = float("nan"), float("inf")
    return [
        S.PriceRequest(indices=[1, 2]),
        S.MCRiskRequest(indices=[1], mc=S.McSpec(sigmas=D.Uncertainty(
            defect_sigma=nan, bond_sigma=inf))),
        S.SearchRequest(jump_prob=inf, risk=D.RiskConfig(
            sigmas=D.Uncertainty(wafer_cost_sigma=nan))),
        S.PriceSystemsRequest(specs=(
            {"kind": "soc", "name": "x", "area": inf, "process": "7nm",
             "quantity": 1.0},
            {"kind": "split", "name": "y", "area": 300.0, "n_chiplets": 2,
             "process": "7nm", "integration": "MCM", "quantity": nan},)),
        S.PriceRequest(indices=[1], deadline_ms=nan),
        S.PriceRequest(indices=[1], deadline_ms=-5.0),
        S.PriceRequest(indices=[1], deadline_ms=25.0),
        S.PriceSystemsRequest(specs=({"kind": "soc", "name": "z",
                                      "area": arr, "process": "7nm",
                                      "quantity": 1.0},)),
    ]


def test_nonfinite_paths_and_validation_equal_the_reference():
    arr = np.ones((3, 4), np.float32)
    arr[1, 2] = np.nan
    arr[2, 0] = -np.inf
    tarr = torch.from_numpy(arr.copy())
    for jr, tr in zip(_nan_requests(JS, JD, arr),
                      _nan_requests(TS, TD, tarr)):
        assert TR.nonfinite_paths(tr, path=tr.kind) == \
            JR.nonfinite_paths(jr, path=jr.kind)
        assert TS.validate_request(tr) == JS.validate_request(jr)
    # a tensor leaf is scanned like the array the reference scans
    assert TR.nonfinite_paths({"x": tarr}) == JR.nonfinite_paths({"x": arr})
    assert TR.nonfinite_paths(tarr.to(torch.bfloat16))
    assert TR.nonfinite_paths(torch.arange(5)) == []     # ints are exempt
    assert TR.nonfinite_paths({"a": 1.0, "b": [1, 2, "x"], "c": None}) == []


def test_service_envelopes_nonfinite_requests(space):
    reqs = [
        TS.MCRiskRequest(indices=[1], mc=TS.McSpec(sigmas=TD.Uncertainty(
            defect_sigma=float("nan")))),
        TS.PriceRequest(indices=[1], deadline_ms=0.0),
        TS.PriceSystemsRequest(specs=(
            {"kind": "soc", "name": "x", "area": float("inf"),
             "process": "7nm", "quantity": 1.0},)),
        TS.PriceSystemsRequest(specs=(
            {"kind": "soc", "name": "y", "area": -120.0,
             "process": "7nm", "quantity": 1.0},)),
        TS.PriceRequest(indices=torch.tensor([1.0, float("nan")])),
    ]
    resps, svc = TS.serve(space, reqs, CFG, device=DEV)
    for r in resps:
        assert not r.ok and r.error.code == TS.INVALID_REQUEST, r
    assert svc.snapshot()["ticks"] == 0    # rejected before the device


# ---------------------------------------------------------------------------
# Deadlines, cancellation, fallback, poison
# ---------------------------------------------------------------------------


def test_deadline_exceeded_in_queue(space):
    async def _main():
        svc = TS.PricingService(space, CFG, device=DEV)
        doomed = asyncio.ensure_future(svc.submit(
            TS.PriceRequest(indices=[0, 1, 2], deadline_ms=10.0)))
        sibling = asyncio.ensure_future(svc.submit(
            TS.PriceRequest(indices=[3, 4])))
        await asyncio.sleep(0.05)          # both admitted; deadline passes
        await svc.start()                  # first tick expires the doomed
        r_doomed, r_sib = await asyncio.gather(doomed, sibling)
        await svc.stop()
        return svc, r_doomed, r_sib

    svc, r_doomed, r_sib = _run(_main())
    assert not r_doomed.ok
    assert r_doomed.error.code == TS.DEADLINE_EXCEEDED
    assert "0/3 rows" in r_doomed.error.message
    assert r_sib.ok
    assert svc.snapshot()["resilience"]["deadline_rejected"] == 1
    assert svc.sched.pending_rows == 0 and svc._deadline_count == 0


def test_search_deadline_between_generations(space):
    cfg = dataclasses.replace(
        CFG, warm_search=(TS.SearchWarmup(population=8, elite=2),))

    async def _main():
        svc = TS.PricingService(space, cfg, device=DEV)
        await svc.start()
        r = await svc.submit(TS.SearchRequest(
            seed=1, population=8, generations=5000, elite=2,
            deadline_ms=250.0))
        await svc.stop()
        return svc, r

    svc, r = _run(_main())
    assert not r.ok and r.error.code == TS.DEADLINE_EXCEEDED
    assert svc.snapshot()["ticks_by_lane"].get("gen", 0) >= 1
    assert svc.sched.pending_rows == 0


def test_cancel_in_queue_releases_budget(space):
    async def _main():
        svc = TS.PricingService(space, CFG, device=DEV)
        task = asyncio.ensure_future(
            svc.submit(TS.PriceRequest(indices=[0, 1, 2])))
        await asyncio.sleep(0)
        assert svc.sched.pending_rows == 3
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        assert svc.sched.pending_rows == 0 and not svc.sched.has_work()
        await svc.start()
        r = await svc.submit(TS.PriceRequest(indices=[5, 6]))
        await svc.stop()
        return svc, r

    svc, r = _run(_main())
    assert r.ok
    assert svc.snapshot()["resilience"]["cancelled"] == 1


def _f32_rows_equal(arrays, j, cr):
    assert np.array_equal(arrays.sku_unit_total[j],
                          np.float32(cr.sku_unit_total))
    assert np.array_equal(arrays.sku_unit_re[j], np.float32(cr.sku_unit_re))
    assert np.array_equal(arrays.sku_unit_nre[j],
                          np.float32(cr.sku_unit_nre))
    assert arrays.portfolio_cost[j] == np.float32(cr.portfolio_cost)


def test_fused_failure_degrades_to_oracle_then_recovers(space, evaluator,
                                                        oracle):
    cfg = dataclasses.replace(CFG, breaker_cooldown_s=60.0)
    p_idx, m_idx = [0, 1, 2, 3, 4], [1, 2, 3]

    async def _main():
        svc = TS.PricingService(space, cfg, device=DEV)
        svc.faults = TR.FaultInjector("seed=1;dispatch_error:p=1.0")
        await svc.start()
        r1 = await svc.submit(TS.PriceRequest(indices=p_idx))
        r2 = await svc.submit(TS.MCRiskRequest(
            indices=m_idx, mc=TS.McSpec(draws=64, quantiles=(0.5, 0.9),
                                        seed=7)))
        svc.faults = TR.FaultInjector("")
        svc.breaker.cooldown_s = 0.0
        r3 = await svc.submit(TS.PriceRequest(indices=p_idx))
        await svc.stop()
        return svc, r1, r2, r3

    svc, r1, r2, r3 = _run(_main())
    assert r1.ok and r2.ok and r3.ok
    assert r1.degraded and r1.degraded_rows.all()
    for j, cr in enumerate(oracle.evaluate(
            [space.candidate_at(i) for i in p_idx])):
        _f32_rows_equal(r1.result, j, cr)
    assert r2.degraded and r2.degraded_rows.all()
    legacy_mc = oracle.evaluate(
        [space.candidate_at(i) for i in m_idx],
        mc_key=prng.PRNGKey(7, DEV), mc_draws=64, mc_quantiles=(0.5, 0.9))
    for j, cr in enumerate(legacy_mc):
        _f32_rows_equal(r2.result, j, cr)
        for k, v in cr.risk.items():
            assert r2.result.risk[k][j] == np.float32(v), k
    assert not r3.degraded and not r3.cached
    direct = evaluator.evaluate_indices(np.asarray(p_idx))
    assert np.array_equal(r3.result.sku_unit_total, direct.sku_unit_total)
    assert np.array_equal(r3.result.portfolio_cost, direct.portfolio_cost)
    res = svc.snapshot()["resilience"]
    assert (res["fallback_ticks"], res["fallback_rows"], res["retries"],
            res["fused_failures"], res["breaker_opens"],
            res["breaker_probes"], res["breaker_closes"]) == \
        (2, len(p_idx) + len(m_idx), 1, 2, 1, 1, 1)
    assert res["breaker"]["state"] == "closed" and res["loop_errors"] == 0


def test_poisoned_row_fails_owner_only(space, evaluator):
    """The poison fault writes NaN into a row of the host copy (the host
    buffers must be writable); exactly its owner fails."""
    a_idx, b_idx = [0, 1, 2, 3, 4, 5, 6, 7], [8, 9, 10, 11, 0, 1, 2, 3]

    async def _main():
        svc = TS.PricingService(space, CFG, device=DEV)
        svc.faults = TR.FaultInjector("seed=3;poison:p=1.0,n=1")
        await svc.start()
        ra, rb = await asyncio.gather(
            svc.submit(TS.PriceRequest(indices=a_idx)),
            svc.submit(TS.PriceRequest(indices=b_idx)))
        await svc.stop()
        return svc, ra, rb

    svc, ra, rb = _run(_main())
    failed = [r for r in (ra, rb) if not r.ok]
    clean = [r for r in (ra, rb) if r.ok]
    assert len(failed) == 1 and len(clean) == 1
    assert failed[0].error.code == TS.NUMERICAL_ERROR
    clean_idx = a_idx if clean[0] is ra else b_idx
    direct = evaluator.evaluate_indices(np.asarray(clean_idx))
    assert np.array_equal(clean[0].result.portfolio_cost,
                          direct.portfolio_cost)
    res = svc.snapshot()["resilience"]
    assert res["numerical_errors"] == 1 and res["faults_injected"] == 1


def test_watchdog_trips_and_dumps_on_stalled_tick(space, tmp_path,
                                                  monkeypatch):
    monkeypatch.setenv("REPRO_FLIGHT_DIR", str(tmp_path))
    cfg = dataclasses.replace(CFG, watchdog_timeout_s=0.1)

    async def _main():
        svc = TS.PricingService(space, cfg, device=DEV)
        svc.faults = TR.FaultInjector("seed=5;stall:p=1.0,ms=500,n=1")
        await svc.start()
        r1 = await svc.submit(TS.PriceRequest(indices=[0, 1]))
        r2 = await svc.submit(TS.PriceRequest(indices=[2, 3]))
        await svc.stop()
        return svc, r1, r2

    svc, r1, r2 = _run(_main())
    assert r1.ok and r2.ok
    res = svc.snapshot()["resilience"]
    assert res["watchdog_trips"] == 1 and res["watchdog_dumps"] == 1
    assert len(list(tmp_path.glob("flight_*.json"))) == 1
    assert res["loop_errors"] == 0


# ---------------------------------------------------------------------------
# A seeded multi-fault chaos schedule: typed-or-correct, zero leakage
# ---------------------------------------------------------------------------

CHAOS = ("seed=13;dispatch_error:p=0.4;poison:p=0.35,n=2;"
         "flood:p=0.25,n=2;recompile:p=0.5,n=1")


def _chaos(S, R, space, device=None):
    cfg = dataclasses.replace(
        S.ServiceConfig(chunk=16, split=4, warm_mc=((64, (0.5, 0.9)),)),
        breaker_cooldown_s=0.05, result_cache_entries=0)
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, space.size(), 8).tolist() for _ in range(12)]
    kw = {} if device is None else {"device": device}

    async def _main():
        svc = S.PricingService(space, cfg, **kw)
        svc.faults = R.FaultInjector(CHAOS)
        await svc.start()
        resps = await asyncio.gather(
            *(svc.submit(S.PriceRequest(indices=b)) for b in batches))
        await svc.stop()
        return svc, resps

    svc, resps = _run(_main())
    return batches, svc, resps


def test_chaos_schedule_typed_and_bit_exact_by_provenance(space, evaluator,
                                                          oracle):
    batches, svc, resps = _chaos(TS, TR, space, DEV)
    res = svc.snapshot()["resilience"]
    assert res["loop_errors"] == 0 and res["faults_injected"] >= 1
    n_ok = 0
    for idx_list, r in zip(batches, resps):
        if not r.ok:
            assert r.error.code in {TS.QUEUE_FULL, TS.NUMERICAL_ERROR}, \
                r.error
            continue
        n_ok += 1
        idx = np.asarray(idx_list, np.int64)
        mask = (r.degraded_rows if r.degraded
                else np.zeros(idx.size, bool))
        fused = evaluator.evaluate_indices(idx)
        legacy = oracle.evaluate_indices_legacy(idx) if mask.any() else None
        for j in range(idx.size):
            src = legacy if mask[j] else fused
            assert np.array_equal(r.result.sku_unit_total[j],
                                  src.sku_unit_total[j]), (j, mask[j])
            assert r.result.portfolio_cost[j] == src.portfolio_cost[j]
    assert n_ok >= 1
    assert svc.sched.pending_rows == 0


def test_chaos_schedule_outcomes_equal_the_reference():
    """The same spec on the same request script fires the same faults in
    both services: the same codes request by request, the same counters."""
    _, jsvc, jresps = _chaos(JS, JR, _space(JD))
    _, tsvc, tresps = _chaos(TS, TR, _space(TD), DEV)
    assert [(r.ok, r.error.code if r.error else None, r.degraded)
            for r in tresps] == \
        [(r.ok, r.error.code if r.error else None, r.degraded)
         for r in jresps]
    jres = jsvc.snapshot()["resilience"]
    tres = tsvc.snapshot()["resilience"]
    for key in ("faults_injected", "retries", "fused_failures",
                "fallback_ticks", "fallback_rows", "numerical_errors",
                "breaker_opens"):
        assert tres[key] == jres[key], key
    assert tres["faults"]["fired"] == jres["faults"]["fired"]
    # the recompile fault fired once: the port meters one first call (its
    # side of "recompile"); JAX's retrace of a cleared jit counts its
    # Python body's traces, which need not be one
    assert tsvc.snapshot()["recompiles_after_warmup"] == 1
    assert jsvc.snapshot()["recompiles_after_warmup"] >= 1


def test_disabled_faults_leave_no_trace(space):
    reqs = [TS.PriceRequest(indices=[0, 1, 2]),
            TS.MCRiskRequest(indices=[3, 4], mc=TS.McSpec(draws=64, seed=2)),
            TS.PriceRequest(indices=[5], deadline_ms=60_000.0)]
    resps, svc = TS.serve(space, reqs, CFG, device=DEV)
    assert all(r.ok for r in resps), [r.error for r in resps]
    assert not any(r.degraded for r in resps)
    assert not svc.faults
    res = svc.snapshot()["resilience"]
    for key in ("retries", "fused_failures", "fallback_ticks",
                "fallback_rows", "numerical_errors", "deadline_rejected",
                "cancelled", "watchdog_trips", "watchdog_dumps",
                "loop_errors", "loop_restarts", "faults_injected",
                "breaker_opens"):
        assert res[key] == 0, key
    assert res["breaker"]["state"] == "closed"
    assert res["deadlines_active"] == 0
    assert svc.snapshot()["recompiles_after_warmup"] == 0
