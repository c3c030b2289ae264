"""The port's crash-safe serving (repro_torch.service.durability and the
service's journal/checkpoint paths) on the CPU, held against the JAX
package where the two must interoperate.

* The wire codec writes the same JSON as the reference's for the same
  request, and each package decodes the other's.
* A journal written by either package replays in the other: the same
  open entries (uid, origin, trace id, wire), a torn tail skipped alike.
* The port's journal rotates and collects garbage as the reference's.
* A ``crash:p=1,n=1`` run of the port's service, resumed from its
  journal, answers as an uncrashed run; a crashed search resumes
  bit-exact against ``portfolio_search``; and a search checkpointed by
  the reference's service resumes in the port's with the same winner.
"""
import asyncio
import json

import numpy as np
import pytest

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


@pytest.fixture(autouse=True)
def _no_env_faults(monkeypatch):
    monkeypatch.delenv("REPRO_FAULTS", raising=False)


def _cfg(S, tmp_path, **kw):
    dcfg = S.DurabilityConfig(directory=tmp_path / "dur", checkpoint_every=1)
    return S.ServiceConfig(chunk=16, split=4, durability=dcfg, **kw)


def _wire_cases(S, D):
    return [
        S.PriceRequest(indices=[3, 1, 7], mc=S.McSpec(
            draws=32, quantiles=(0.5,), seed=9,
            sigmas=D.Uncertainty(defect_sigma=0.1, wafer_cost_sigma=0.2,
                                 bond_sigma=0.3, interposer_sigma=0.4))),
        S.RankRequest(indices=None, top_k=5, objective="cost"),
        S.MCRiskRequest(indices=[2, 4], mc=S.McSpec(draws=16),
                        deadline_ms=500.0),
        S.WhatIfRequest(base=3, processes=("7nm",), integrations=("MCM",)),
        S.SearchRequest(seed=11, population=8, generations=4, elite=2,
                        risk=D.RiskConfig(n_draws=16, quantile=0.8)),
        S.PriceSystemsRequest(specs=({"kind": "soc", "name": "a",
                                      "area": 100.0, "process": "7nm",
                                      "quantity": 1.0},)),
    ]


@pytest.mark.parametrize("i", range(6))
def test_wire_codec_equals_the_reference(i):
    jreq, treq = _wire_cases(JS, JD)[i], _wire_cases(TS, TD)[i]
    d = TS.request_to_wire(treq)
    assert json.dumps(d, sort_keys=True) == \
        json.dumps(JS.request_to_wire(jreq), sort_keys=True)
    assert TS.request_from_wire(d) == treq
    assert TS.request_to_wire(TS.request_from_wire(
        JS.request_to_wire(jreq))) == d
    assert JS.request_to_wire(JS.request_from_wire(d)) == d


def test_wire_resolves_candidates_to_indices(space):
    d = TS.request_to_wire(TS.PriceRequest(
        candidates=(space.candidate_at(5),)), space)
    assert d["indices"] == [5]
    assert TS.request_from_wire(d).indices == [5]


def _write_journal(S, path):
    j = S.RequestJournal(path, fsync_every=2, fingerprint="fp")
    for uid, req in enumerate(_wire_cases(S, JD if S is JS else TD), 1):
        j.admit(uid, S.request_to_wire(req), trace_id=f"t{uid}")
    j.done(2, "ok")
    j.admit(9, S.request_to_wire(S.PriceRequest(indices=[1])), origin=4,
            trace_id="t4")
    j.done(4, "replayed")
    j.close()


def _replay(S, path):
    j = S.RequestJournal(path)
    out = [(e.uid, e.origin, e.trace_id, e.wire, S.request_to_wire(e.request))
           for e in j.replay()]
    stats = (j.max_uid, j.torn_records, j.open_count)
    j.close()
    return out, stats


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_journal_replays_across_packages(tmp_path, writer):
    W, _ = (JS, TS) if writer == "jax" else (TS, JS)
    _write_journal(W, tmp_path)
    assert _replay(TS, tmp_path) == _replay(JS, tmp_path)
    entries, (max_uid, torn, n_open) = _replay(TS, tmp_path)
    assert [e[0] for e in entries] == [1, 3, 5, 6, 9]
    assert entries[-1][1] == 4 and max_uid == 9 and torn == 0


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_torn_tail_is_skipped_alike(tmp_path, writer):
    W = JS if writer == "jax" else TS
    j = W.RequestJournal(tmp_path)
    j.admit(1, W.request_to_wire(W.PriceRequest(indices=[1])))
    j.admit(2, W.request_to_wire(W.PriceRequest(indices=[2])))
    j.close()
    seg = sorted(tmp_path.glob("journal_*.log"))[-1]
    seg.write_text(seg.read_text()[:-20])
    for S in (TS, JS):
        j2 = S.RequestJournal(tmp_path)
        assert j2.torn_records == 1
        assert [e.uid for e in j2.replay()] == [1]
        j2.close()


def test_journal_rotation_and_gc(tmp_path):
    def wire(i):
        return TS.request_to_wire(TS.PriceRequest(indices=[i]))

    j = TS.RequestJournal(tmp_path, segment_max_records=2)
    j.admit(1, wire(1))                          # stays open throughout
    for i in range(2, 8):
        j.admit(i, wire(i))
        j.done(i, "ok")
    assert j.rotations >= 4 and j.open_count == 1
    assert len(list(tmp_path.glob("journal_*.log"))) <= 2
    j.close()
    # the carried-forward admit replays in both packages
    for S in (TS, JS):
        j2 = S.RequestJournal(tmp_path)
        assert [(e.uid, e.origin) for e in j2.replay()] == [(1, 1)]
        j2.close()
    j3 = TS.RequestJournal(tmp_path)
    j3.done(1, "ok")
    j3.close()
    assert TS.RequestJournal(tmp_path).replay() == []


def test_journal_fsync_batching_and_stats_hook(tmp_path):
    seen = {}
    j = TS.RequestJournal(tmp_path, fsync_every=4,
                          stats_hook=lambda k, n: seen.__setitem__(
                              k, seen.get(k, 0) + n))
    for i in range(1, 9):
        j.admit(i, TS.request_to_wire(TS.PriceRequest(indices=[i])))
    assert j.appends == 8 and j.fsyncs == 2
    j.close()
    assert seen == {"journal_appends": 8, "journal_fsyncs": 2}


# ---------------------------------------------------------------------------
# Crash -> journal replay through the port's service
# ---------------------------------------------------------------------------

def _crash_script():
    mc = TS.McSpec(draws=64, quantiles=(0.5, 0.9), seed=2)
    return [TS.PriceRequest(indices=[2, 6, 9]),
            TS.RankRequest(indices=[0, 1, 2, 3, 4, 5], top_k=2),
            TS.MCRiskRequest(indices=[1, 4], mc=mc),
            TS.WhatIfRequest(base=3),
            TS.PriceSystemsRequest(specs=(
                {"kind": "soc", "name": "s", "area": 120.0,
                 "process": "7nm", "quantity": 1e6},))]


def _payload(r):
    res = r.result
    if r.kind in ("price", "mc_risk"):
        return (res.idx.tolist(), res.portfolio_cost.tolist(),
                {k: v.tolist() for k, v in (res.risk or {}).items()})
    if r.kind == "rank":
        return res.order.tolist(), res.values.tolist()
    if r.kind == "what_if":
        return res.base_cost, res.rows, res.skipped
    return res.rows


def test_crash_replay_answers_as_an_uncrashed_run(space, tmp_path):
    reqs = _crash_script()
    cfg = TS.ServiceConfig(chunk=16, split=4, warm_mc=((64, (0.5, 0.9)),))
    clean, _ = TS.serve(space, reqs, cfg, device=DEV)

    async def main():
        svc = TS.PricingService(space, _cfg(TS, tmp_path), device=DEV)
        await svc.start()
        svc.faults = TR.FaultInjector("seed=1;crash:p=1.0,n=1")
        crashed = await asyncio.gather(*(svc.submit(r) for r in reqs))
        assert all(not r.ok and r.error.code == TS.SHUTTING_DOWN
                   for r in crashed)
        assert svc.snapshot()["durability"]["crashes"] == 1
        await svc.stop()
        svc.faults = TR.FaultInjector("")
        await svc.start()
        replayed = await svc.drain_replayed()
        await svc.stop()
        return crashed, replayed

    crashed, replayed = asyncio.run(main())
    assert len(replayed) == len(reqs)
    by_trace = {r.trace_id: r for r in replayed}
    for c, want in zip(crashed, clean):
        got = by_trace[c.trace_id]             # the trace id survives
        assert got.ok and got.replayed and got.kind == want.kind
        assert got.replayed_from == c.request_id
        assert _payload(got) == _payload(want)
    j = TS.RequestJournal(tmp_path / "dur" / "journal")
    assert j.replay() == []
    j.close()


def test_crashed_search_resumes_bit_exact(space, tmp_path):
    async def main():
        svc = TS.PricingService(space, _cfg(TS, tmp_path), device=DEV)
        await svc.start()
        # seed=1 p=0.3: the first crash fire is check 6
        svc.faults = TR.FaultInjector("seed=1;crash:p=0.3,n=1")
        resp = await svc.submit(TS.SearchRequest(
            seed=3, population=8, generations=10, elite=3))
        assert not resp.ok and resp.error.code == TS.SHUTTING_DOWN
        await svc.stop()
        svc.faults = TR.FaultInjector("")
        await svc.start()
        (rr,) = await svc.drain_replayed()
        await svc.stop()
        snap = svc.snapshot()["durability"]
        assert snap["checkpoints_restored"] == 1
        assert snap["checkpoints_removed"] >= 1
        return rr

    rr = asyncio.run(main())
    assert rr.ok and rr.replayed
    oracle = TD.portfolio_search(
        space, prng.PRNGKey(3, DEV), population=8, generations=10, elite=3,
        evaluator=TD.ChunkedEvaluator(space, 16, device=DEV))
    assert rr.result.history == oracle.history
    assert [r.label for r in rr.result.ranked] == \
        [r.label for r in oracle.ranked]
    assert [r.portfolio_cost for r in rr.result.ranked] == \
        [r.portfolio_cost for r in oracle.ranked]


def test_reference_checkpointed_search_resumes_in_the_port(space, tmp_path):
    """The JAX service journals a search, checkpoints it and crashes; the
    port's service over the same directory replays the journal, restores
    the JAX checkpoint and finishes with the same winner and history
    labels as an uninterrupted search."""
    jspace = _space(JD)

    async def jax_side():
        svc = JS.PricingService(jspace, _cfg(JS, tmp_path))
        await svc.start()
        svc.faults = JR.FaultInjector("seed=1;crash:p=0.3,n=1")
        resp = await svc.submit(JS.SearchRequest(
            seed=3, population=8, generations=10, elite=3))
        assert not resp.ok and resp.error.code == JS.SHUTTING_DOWN
        await svc.stop()
        return resp

    async def torch_side():
        svc = TS.PricingService(space, _cfg(TS, tmp_path), device=DEV)
        await svc.start()
        (rr,) = await svc.drain_replayed()
        await svc.stop()
        return rr, svc.snapshot()["durability"]

    crashed = asyncio.run(jax_side())
    rr, snap = asyncio.run(torch_side())
    assert snap["journal_replayed"] == 1
    assert snap["checkpoints_restored"] == 1
    assert rr.ok and rr.replayed and rr.trace_id == crashed.trace_id
    oracle = TD.portfolio_search(
        space, prng.PRNGKey(3, DEV), population=8, generations=10, elite=3,
        evaluator=TD.ChunkedEvaluator(space, 16, device=DEV))
    assert rr.result.best.label == oracle.best.label
    assert [h["best_label"] for h in rr.result.history] == \
        [h["best_label"] for h in oracle.history]
    assert [h["evaluated"] for h in rr.result.history] == \
        [h["evaluated"] for h in oracle.history]


def test_port_journal_replays_in_the_reference_service(space, tmp_path):
    async def torch_side():
        svc = TS.PricingService(space, _cfg(TS, tmp_path), device=DEV)
        await svc.start()
        svc.faults = TR.FaultInjector("seed=1;crash:p=1.0,n=1")
        r = await svc.submit(TS.PriceRequest(indices=[3, 7, 11]))
        assert not r.ok
        await svc.stop()

    async def jax_side():
        svc = JS.PricingService(_space(JD), _cfg(JS, tmp_path))
        await svc.start()
        (rr,) = await svc.drain_replayed()
        await svc.stop()
        return rr

    asyncio.run(torch_side())
    rr = asyncio.run(jax_side())
    assert rr.ok and rr.replayed and rr.result.idx.tolist() == [3, 7, 11]
    want = TD.ChunkedEvaluator(space, 16, device=DEV).evaluate_indices(
        np.asarray([3, 7, 11]))
    np.testing.assert_allclose(rr.result.portfolio_cost,
                               want.portfolio_cost, rtol=1e-5)


def test_uid_continuity_and_drain(space, tmp_path):
    async def main():
        svc = TS.PricingService(space, _cfg(TS, tmp_path), device=DEV)
        await svc.start()
        svc.faults = TR.FaultInjector("seed=1;crash:p=1.0,n=1")
        r = await svc.submit(TS.PriceRequest(indices=[1]))
        await svc.stop()
        svc2 = TS.PricingService(space, _cfg(TS, tmp_path), device=DEV)
        await svc2.start()
        replayed = await svc2.drain_replayed()
        fresh = await svc2.submit(TS.PriceRequest(indices=[2]))
        await svc2.stop()
        late = await svc2.submit(TS.PriceRequest(indices=[2]))
        return r, replayed, fresh, late, svc2

    r, replayed, fresh, late, svc2 = asyncio.run(main())
    assert replayed[0].ok
    assert fresh.request_id > r.request_id
    assert replayed[0].request_id > r.request_id
    assert not late.ok and late.error.code == TS.SHUTTING_DOWN
    snap = svc2.snapshot()["durability"]
    assert snap["enabled"] and snap["journal"] is None
