"""The port's observability (repro_torch.obs) against the JAX package's, on
the CPU.

The registry, ledger, SLO tracker and flight recorder are copies: the
same event scripts must leave the same snapshots.  The probes of
``obs.torchhooks`` stand where the jit probes stood: a probe counts one
first call per argument signature and dispatches after it (tracing on or
off), ``to_host`` counts calls and bytes, and the ``recompile`` fault
makes the next dispatch a metered first call.
"""
import asyncio
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.obs as JO
import repro_torch.obs as TO
from repro.obs.flight import FlightRecorder as JFlight
from repro.obs.ledger import Ledger as JLedger
from repro.obs.registry import Registry as JRegistry
from repro.obs.registry import TraceCounts as JTraceCounts
from repro.obs.slo import SLObjective as JObjective
from repro.obs.slo import SLOTracker as JTracker
from repro_torch.core import CostEngine, SystemBatch, pad_batch, soc_system
from repro_torch.core import engine as tengine
from repro_torch.dse import ChunkedEvaluator, DesignSpace, SKU
from repro_torch.dse import evaluate as tevaluate
from repro_torch.obs import torchhooks
from repro_torch.obs.flight import FlightRecorder as TFlight
from repro_torch.obs.ledger import Ledger as TLedger
from repro_torch.obs.registry import Registry as TRegistry
from repro_torch.obs.registry import TraceCounts as TTraceCounts
from repro_torch.obs.slo import SLObjective as TObjective
from repro_torch.obs.slo import SLOTracker as TTracker
from repro_torch.obs.trace import TRACER
from repro_torch.resilience import FaultInjector
from repro_torch.service import PriceRequest, PricingService, ServiceConfig

DEV = "cpu"


@pytest.fixture
def traced():
    """Enable the port's tracing for one test, restoring prior state."""
    was = TO.enabled()
    TO.enable()
    TRACER.clear()
    yield
    TRACER.clear()
    if not was:
        TO.disable()


@pytest.fixture(autouse=True)
def _no_env_faults(monkeypatch):
    monkeypatch.delenv("REPRO_FAULTS", raising=False)


# ---------------------------------------------------------------------------
# Copies: the same scripts, the same snapshots
# ---------------------------------------------------------------------------


def _registry_script(Registry, TraceCounts):
    reg = Registry()
    c = reg.counter("reqs", help="requests")
    c.inc()
    c.inc(4)
    g = reg.gauge("depth")
    g.set(7)
    g.dec(2)
    h = reg.histogram("lat", max_samples=64)
    for i in range(1000):
        h.observe(float(i) * 0.5, exemplar=f"t{i}" if i % 97 == 0 else None)
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(TypeError):
        reg.gauge("reqs")
    # the trace counters' help text names the framework; their counts
    # and snapshots are the same
    treg = Registry()
    tc = TraceCounts(registry=treg, prefix="trace")
    tc["a"] += 2
    tc["b"] += 1
    return reg.snapshot(), reg.exposition(), dict(tc), treg.snapshot()


def test_registry_script_equals_the_reference():
    assert _registry_script(TRegistry, TTraceCounts) == \
        _registry_script(JRegistry, JTraceCounts)


def _ledger_script(Ledger, Registry):
    reg = Registry()
    led = Ledger(registry=reg, keep_closed=4)
    bills = [led.open(f"trace{i}", i, ("price", "rank", "search")[i % 3],
                      replayed=i == 4) for i in range(6)]
    led.charge_tick("chunk", 0.012, [(bills[0], 96), (bills[1], 32)],
                    slots=128, used=128, dispatch_s=0.004, retries=1)
    led.charge_tick("chunk", 0.007, [(bills[1], 16), (bills[2], 40)],
                    slots=128, used=56)
    led.charge_tick("gen", 0.003, [(bills[3], 32)], slots=32, used=32)
    led.charge_tick("raw", 0.002, [], slots=16, used=0)
    led.close(bills[0], status="ok", latency_s=0.02)
    led.close(bills[1], status="ok", cache_hit=False, degraded_rows=3,
              latency_s=0.03)
    led.close(bills[2], status="numerical_error", latency_s=0.01)
    led.close(bills[2], status="ok")                 # second terminal: no-op
    led.close(bills[4], status="ok", cache_hit=True, latency_s=0.001)
    led.close(bills[5], status="cancelled", latency_s=0.5)
    led.charge_tick("chunk", 0.004, [(bills[0], 8)], slots=16, used=8)
    snap = led.snapshot()
    out = {"snap": snap, "bill3": led.bill_for(3).as_dict(),
           "bill1": led.bill_for(1).as_dict(), "missing": led.bill_for(99)}
    regsnap = reg.snapshot()
    return out, regsnap


def test_ledger_script_equals_the_reference():
    assert _ledger_script(TLedger, TRegistry) == \
        _ledger_script(JLedger, JRegistry)


def _slo_script(Objective, Tracker, Registry):
    burns = []
    reg = Registry()
    tr = Tracker([Objective(kind="*", latency_ms=100.0, latency_target=0.9,
                            availability=0.95, window_s=10.0),
                  Objective(kind="price", latency_ms=20.0,
                            latency_target=0.5, window_s=5.0,
                            alert_burn_rate=1.5)],
                 registry=reg, on_burn=lambda *a: burns.append(a))
    rng = np.random.default_rng(3)
    snaps = []
    for i in range(200):
        kind = ("price", "rank", "search")[int(rng.integers(0, 3))]
        tr.observe(kind, float(rng.exponential(0.04)),
                   bool(rng.random() > 0.03), trace_id=f"t{i}",
                   now=0.1 * i)
        if i % 25 == 0:
            snaps.append(tr.snapshot())
    return burns, snaps, tr.snapshot(), reg.snapshot(), tr.observed


def test_slo_script_equals_the_reference():
    assert _slo_script(TObjective, TTracker, TRegistry) == \
        _slo_script(JObjective, JTracker, JRegistry)


def _flight_script(Flight, path):
    fr = Flight(capacity=4)
    for i in range(10):
        fr.record("tick", lane="chunk", rows=i, wall_s=1e-3)
    fr.record("request_error", uid=9, kind="price", error="boom")
    recs = [{k: v for k, v in r.items() if k != "t_s"}
            for r in fr.records()]
    doc = json.loads(fr.dump(path).read_text())
    evs = [{k: v for k, v in e.items() if k not in ("ts", "pid")}
           for e in doc["traceEvents"]]
    return len(fr), fr.n_recorded, fr.n_dumps, recs, evs


def test_flight_recorder_equals_the_reference(tmp_path):
    assert _flight_script(TFlight, tmp_path / "t.json") == \
        _flight_script(JFlight, tmp_path / "j.json")


def test_obs_exports_mirror_the_reference():
    assert set(TO.__all__) - {"torchhooks"} == set(JO.__all__) - {"jaxhooks"}
    for name in ("instrument", "probes", "stats", "reset", "total_compiles",
                 "total_dispatch_s", "recompiles_since", "device_get_stats"):
        assert callable(getattr(torchhooks, name)), name


# ---------------------------------------------------------------------------
# Probes: first call per signature, dispatches after
# ---------------------------------------------------------------------------


@pytest.fixture
def probe():
    p = torchhooks.instrument(lambda x, *, k=1: x * k, "test.fn")
    yield p
    torchhooks._PROBES.remove(p)


@pytest.mark.parametrize("on", [False, True])
def test_probe_counts_one_first_call_per_signature(probe, on, traced):
    if not on:
        TO.disable()
    x = torch.arange(4.0)
    before = torchhooks.total_compiles()
    probe(x)                                       # first call
    probe(x + 1.0)                                 # same signature
    probe(x, k=1)
    st = probe.summary()
    assert st["signatures"] == 2                   # k= is a static argument
    assert st["compiles"] == 2 and st["calls"] == 1
    probe(torch.arange(8.0))                       # new shape
    probe(torch.arange(4, dtype=torch.float64))    # new dtype
    probe(x, k=2)                                  # new static value
    probe(torch.arange(8.0))
    st = probe.summary()
    assert st["signatures"] == 5 and st["compiles"] == 5
    assert st["calls"] == 2
    assert torchhooks.recompiles_since(before) == 5
    if on:
        assert st["compile_s"] > 0 and st["dispatch_s"] > 0
        assert TRACER.count("jit_compile") == 5
        assert TRACER.count("kernel_dispatch") == 2
    else:
        assert st["compile_s"] == 0 and st["dispatch_s"] == 0
        assert TRACER.count("jit_compile") == 0
    probe.reset()                                  # stats go, warmth stays
    probe(x)
    assert probe.summary()["compiles"] == 0
    probe.forget()                                 # the recompile fault
    probe(x)
    assert probe.summary()["compiles"] == 1


def test_probe_signature_walks_the_batch_but_not_its_names():
    """A SystemBatch flattens to its tensor leaves (names are display
    metadata), so raw groups of different systems share one signature."""
    engine = CostEngine()

    def padded(name):
        b = SystemBatch.from_systems([soc_system(name, 120.0, "7nm")],
                                     share_nre=[0], device=DEV)
        return pad_batch(b, n_systems=4, max_chips=2, chip_entities=9,
                         pkg_entities=5, mod_entities=17, mod_instances=16,
                         d2d_entities=9, d2d_instances=8)

    p = tengine._TOTAL_PROBE
    a, b = padded("a"), padded("b")
    assert a.names != b.names
    assert p.signature((a, "chip-last"), {}) == \
        p.signature((b, "chip-last"), {})
    assert p.signature((a, "chip-last"), {}) != \
        p.signature((a, "chip-first"), {})
    n0 = p.first_calls
    engine.total(a)
    engine.total(b)
    assert p.first_calls - n0 <= 1


def test_direct_apis_run_through_the_module_probes():
    space = DesignSpace(skus=(SKU("a", 200.0, 1e6),), processes=("7nm",),
                        integrations=("MCM",), chiplet_counts=(1, 2),
                        allow_reuse=False)
    ev = ChunkedEvaluator(space, candidates_per_chunk=8, device=DEV)
    idx = np.arange(space.size(), dtype=np.int64)
    before = tevaluate._CHUNK_PROBE.summary()
    ev.evaluate_indices(idx)
    ev.evaluate_indices(idx)
    after = tevaluate._CHUNK_PROBE.summary()
    assert after["compiles"] + after["calls"] == \
        before["compiles"] + before["calls"] + 2


def test_tracing_a_warmed_sweep_makes_no_first_call_and_same_bits():
    space = DesignSpace(skus=(SKU("a", 200.0, 1e6),), processes=("7nm",),
                        integrations=("MCM",), chiplet_counts=(1, 2),
                        allow_reuse=False)
    ev = ChunkedEvaluator(space, candidates_per_chunk=8, device=DEV)
    idx = np.arange(space.size(), dtype=np.int64)
    ev.evaluate_indices(idx)
    baseline = ev.evaluate_indices(idx)
    warm = torchhooks.total_compiles()
    TO.enable()
    TRACER.clear()
    try:
        traced = ev.evaluate_indices(idx)
        assert TRACER.count("kernel_dispatch") >= 1
        assert TRACER.count("jit_compile") == 0
    finally:
        TO.disable()
        TRACER.clear()
    assert torchhooks.total_compiles() == warm
    assert np.array_equal(traced.portfolio_cost, baseline.portfolio_cost)
    assert np.array_equal(traced.sku_unit_total, baseline.sku_unit_total)


# ---------------------------------------------------------------------------
# to_host: the counted copy; enable() patches nothing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("on", [False, True])
def test_to_host_counts_calls_and_bytes(on, traced):
    if not on:
        TO.disable()
    before = torchhooks.device_get_stats()
    x = torch.arange(16, dtype=torch.float32)
    host = torchhooks.to_host(x)
    assert isinstance(host, np.ndarray) and host.flags.writeable
    assert np.array_equal(host, np.arange(16, dtype=np.float32))
    tree = torchhooks.to_host({"a": x[:4], "b": (x[:2].double(), 3)})
    assert tree["b"][1] == 3 and tree["b"][0].dtype == np.float64
    after = torchhooks.device_get_stats()
    assert after["calls"] == before["calls"] + 2
    assert after["bytes"] == before["bytes"] + 64 + 16 + 16
    assert TRACER.count("device_get") == (2 if on else 0)


def test_enable_patches_no_torch_function():
    names = ("cpu", "numpy", "item", "tolist", "to")
    before = {n: getattr(torch.Tensor, n) for n in names}
    TO.enable()
    try:
        assert {n: getattr(torch.Tensor, n) for n in names} == before
    finally:
        TO.disable()
        TRACER.clear()


# ---------------------------------------------------------------------------
# The recompile fault through the service: a metered first call
# ---------------------------------------------------------------------------


def test_recompile_fault_makes_the_next_dispatch_a_metered_first_call():
    space = DesignSpace(skus=(SKU("a", 200.0, 1e6), SKU("b", 300.0, 2e5)),
                        processes=("7nm", "12nm"), integrations=("MCM",),
                        chiplet_counts=(1, 2, 4), allow_reuse=True)
    cfg = ServiceConfig(chunk=16, split=4, warm_mc=())

    async def _main(spec):
        svc = PricingService(space, cfg, device=DEV)
        await svc.start()
        svc.faults = FaultInjector(spec)
        before = tevaluate._CHUNK_PROBE.summary()["compiles"]
        rs = [await svc.submit(PriceRequest(indices=[i, i + 1]))
              for i in range(3)]
        after = tevaluate._CHUNK_PROBE.summary()["compiles"]
        await svc.stop()
        return svc, rs, after - before

    svc, rs, first_calls = asyncio.run(_main("seed=0;recompile:p=1.0,n=1"))
    assert all(r.ok for r in rs)
    assert first_calls == 1
    snap = svc.snapshot()
    assert snap["recompiles_after_warmup"] == 1
    assert snap["trace"]["tick_recompiles"] == 1
    assert snap["resilience"]["faults_injected"] == 1
    assert [r["recompiled"] for r in svc.flight.records("tick")] == \
        [True, False, False]

    svc, rs, first_calls = asyncio.run(_main(""))
    assert all(r.ok for r in rs) and first_calls == 0
    assert svc.snapshot()["recompiles_after_warmup"] == 0


def test_service_snapshot_obs_block_when_traced(traced):
    space = DesignSpace(skus=(SKU("a", 200.0, 1e6),), processes=("7nm",),
                        integrations=("MCM",), chiplet_counts=(1, 2),
                        allow_reuse=False)
    from repro_torch.service import serve
    resps, svc = serve(space, [PriceRequest(indices=[0, 1])],
                       ServiceConfig(chunk=8, warm_mc=()), device=DEV)
    assert resps[0].ok
    o = svc.snapshot()["obs"]
    assert set(o) == {"phases", "tick_coverage", "jit", "device_get",
                      "recompiles_in_ticks"}
    assert o["recompiles_in_ticks"] == 0
    assert o["device_get"]["calls"] >= 1
    assert "dse.chunk" in o["jit"]
    assert dataclasses.is_dataclass(torchhooks.SignatureStats())
