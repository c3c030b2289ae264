"""Service observability: per-request latency, tick occupancy, cache and
recompile counters — exported as a JSON snapshot for the bench and tests
(a copy of the JAX package's ``service/metrics.py``).

Three measurement surfaces:

* **requests** — submit -> first-result -> done latencies per request
  (the continuous-batching promise: point queries stay fast while sweeps
  stream), split by request kind.
* **ticks** — slot occupancy vs padded waste per device tick — reported
  **per lane** (chunk / mc / gen / raw) and in aggregate, so search
  (``gen``) work is no longer a blind spot — plus the
  one-device-to-host-copy-per-tick invariant counter (``device_gets``).
* **caches/traces** — result-cache hit rates and post-warmup recompile
  counts (folded in from the cache layer at snapshot time).

Every counter is also mirrored into the stack-wide
:data:`repro_torch.obs.registry.REGISTRY` (``service_*`` instruments),
so one text/JSON scrape of the registry sees the service next to the
probes' counters.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Dict, List, Optional

import numpy as np

from ..obs.registry import REGISTRY


@dataclasses.dataclass
class RequestRecord:
    kind: str
    n_rows: int
    t_submit: float
    t_first: float = 0.0
    t_done: float = 0.0
    ok: bool = True
    cached: bool = False
    trace_id: str = ""

    @property
    def latency_s(self) -> float:
        return max(0.0, self.t_done - self.t_submit)

    @property
    def ttfr_s(self) -> float:
        return max(0.0, self.t_first - self.t_submit)


def _quantiles(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "mean": 0.0}
    a = np.asarray(xs, np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "p99": float(np.percentile(a, 99)),
            "mean": float(a.mean())}


@dataclasses.dataclass
class LaneStats:
    """Per-lane tick accounting (one row per lane kind)."""

    ticks: int = 0
    slots_used: int = 0
    slots_total: int = 0
    rows_priced: int = 0
    busy_s: float = 0.0

    @property
    def occupancy(self) -> float:
        return self.slots_used / self.slots_total if self.slots_total \
            else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {"ticks": self.ticks, "slots_used": self.slots_used,
                "slots_total": self.slots_total,
                "rows_priced": self.rows_priced, "busy_s": self.busy_s,
                "occupancy": self.occupancy,
                "padded_waste_frac": (1.0 - self.occupancy
                                      if self.slots_total else 0.0)}


# Every resilience counter the service tracks, with its registry help
# string.  One flat namespace: the snapshot block and the Prometheus
# mirror (service_<name>) stay in lockstep by construction.
_RESILIENCE_COUNTERS = {
    "retries": "fused dispatch retry attempts",
    "fused_failures": "fused dispatch attempts that raised",
    "fallback_ticks": "ticks priced via the legacy host-packing fallback",
    "fallback_rows": "rows priced in degraded (fallback) mode",
    "fallback_busy_s": "wall seconds inside fallback pricing",
    "breaker_opens": "circuit breaker closed/half_open -> open transitions",
    "breaker_closes": "circuit breaker -> closed transitions",
    "breaker_probes": "circuit breaker half-open probe admissions",
    "deadline_rejected": "requests failed with deadline_exceeded",
    "numerical_errors": "requests failed with numerical_error",
    "cancelled": "requests cancelled by the client before completion",
    "watchdog_trips": "stuck-tick watchdog trips",
    "watchdog_dumps": "flight-recorder dumps triggered by the watchdog",
    "loop_errors": "exceptions that escaped a tick into the loop guard",
    "loop_restarts": "tick-loop tasks relaunched after dying",
    "faults_injected": "REPRO_FAULTS faults actually fired",
}


# Durability counters: the crash-safety mirror of the resilience block.
# Journal I/O counters are forwarded by the RequestJournal's stats_hook;
# the lifecycle counters are bumped by the service directly.
_DURABILITY_COUNTERS = {
    "journal_appends": "journal records appended (admit/done/meta)",
    "journal_fsyncs": "journal fsync barriers issued",
    "journal_rotations": "journal segment rotations",
    "journal_replayed": "admitted requests re-admitted from the journal",
    "checkpoints_written": "search checkpoints published (atomic rename)",
    "checkpoints_restored": "search lanes restored from a checkpoint",
    "checkpoint_corrupt_fallbacks":
        "corrupt checkpoint steps skipped during restore",
    "checkpoints_removed": "search checkpoint dirs removed on completion",
    "drain_calls": "stop() invocations that entered the drain path",
    "drain_timeouts": "drains that hit drain_timeout_s",
    "drain_rejected": "in-flight requests typed-rejected at drain deadline",
    "drain_checkpointed": "searches checkpointed at the drain deadline",
    "crashes": "simulated crashes (REPRO_FAULTS crash kind) enacted",
}


class DurabilityStats:
    """Crash-safety counters owned by one :class:`PricingService`.

    Same contract as :class:`ResilienceStats`: ``bump(name)`` updates the
    local field and mirrors ``service_<name>`` into the registry, so
    ``svc.snapshot()["durability"]`` and a scrape always agree.
    """

    def __init__(self):
        self.reset()

    def reset(self):
        for name in _DURABILITY_COUNTERS:
            setattr(self, name, 0)

    def bump(self, name: str, n=1):
        if name not in _DURABILITY_COUNTERS:
            raise KeyError(f"unknown durability counter {name!r}")
        setattr(self, name, getattr(self, name) + n)
        REGISTRY.counter(f"service_{name}",
                         help=_DURABILITY_COUNTERS[name]).inc(n)

    def snapshot(self) -> Dict:
        return {name: getattr(self, name) for name in _DURABILITY_COUNTERS}


class ResilienceStats:
    """Failure-handling counters owned by one :class:`PricingService`.

    ``bump(name)`` increments the local field and mirrors it into the
    stack-wide registry as ``service_<name>`` — the satellite obs
    contract: ``svc.snapshot()["resilience"]`` and a Prometheus scrape
    always agree.
    """

    def __init__(self):
        self.reset()

    def reset(self):
        for name in _RESILIENCE_COUNTERS:
            setattr(self, name, 0.0 if name.endswith("_s") else 0)

    def bump(self, name: str, n=1):
        if name not in _RESILIENCE_COUNTERS:
            raise KeyError(f"unknown resilience counter {name!r}")
        setattr(self, name, getattr(self, name) + n)
        REGISTRY.counter(f"service_{name}",
                         help=_RESILIENCE_COUNTERS[name]).inc(n)

    def snapshot(self) -> Dict:
        return {name: getattr(self, name) for name in _RESILIENCE_COUNTERS}


class ServiceMetrics:
    """Mutable counters owned by one :class:`PricingService`."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.requests: List[RequestRecord] = []
        self.n_errors = 0
        self.n_rejected = 0                  # backpressure rejections
        self.ticks = 0
        self.device_gets = 0
        self.slots_used = 0
        self.slots_total = 0
        self.gen_ticks = 0
        self.rows_priced = 0                 # candidate rows through kernels
        self.busy_s = 0.0                    # wall inside ticks
        self.per_lane: Dict[str, LaneStats] = {}
        self.t_start = time.perf_counter()

    # -- request lifecycle ---------------------------------------------------
    def start_request(self, kind: str, n_rows: int, t_submit: float,
                      trace_id: str = "") -> RequestRecord:
        rec = RequestRecord(kind=kind, n_rows=n_rows, t_submit=t_submit,
                            trace_id=trace_id)
        self.requests.append(rec)
        REGISTRY.counter("service_requests",
                         help="requests submitted").inc()
        return rec

    def reject(self):
        self.n_rejected += 1
        REGISTRY.counter("service_rejected",
                         help="backpressure rejections").inc()

    def finish_request(self, rec: RequestRecord, ok: bool,
                       cached: bool = False):
        rec.t_done = time.perf_counter()
        if not rec.t_first:
            rec.t_first = rec.t_done
        rec.ok = ok
        rec.cached = cached
        if not ok:
            self.n_errors += 1
            REGISTRY.counter("service_errors",
                             help="requests finished not-ok").inc()
        else:
            # the trace_id exemplar ties the latency distribution back to
            # concrete traced requests (OpenMetrics-style)
            REGISTRY.histogram("service_latency_s",
                               help="ok-request latency").observe(
                rec.latency_s, exemplar=rec.trace_id or None)

    # -- tick accounting -----------------------------------------------------
    def record_tick(self, lane_kind: str, slots: int, used: int,
                    rows_priced: int, wall_s: float):
        """One device tick.  ``gen`` lanes price their whole population
        every tick, so callers pass ``slots == used == rows_priced`` for
        them — search work counts toward occupancy and rows like every
        other lane instead of being silently excluded."""
        self.ticks += 1
        self.device_gets += 1        # the tick loop copies back exactly once
        self.busy_s += wall_s
        self.rows_priced += rows_priced
        self.slots_used += used
        self.slots_total += slots
        lane = self.per_lane.setdefault(lane_kind, LaneStats())
        lane.ticks += 1
        lane.slots_used += used
        lane.slots_total += slots
        lane.rows_priced += rows_priced
        lane.busy_s += wall_s
        if lane_kind == "gen":
            self.gen_ticks += 1
        REGISTRY.counter("service_ticks", help="device ticks").inc()
        REGISTRY.counter("service_rows_priced",
                         help="candidate rows priced").inc(rows_priced)
        REGISTRY.counter(f"service_ticks_{lane_kind}").inc()

    # -- snapshot ------------------------------------------------------------
    def snapshot(self, trace_stats: Optional[Dict] = None,
                 cache_stats: Optional[Dict] = None) -> Dict:
        done = [r for r in self.requests if r.t_done]
        ok = [r for r in done if r.ok]
        snap = {
            "n_requests": len(self.requests),
            "n_done": len(done),
            "n_ok": len(ok),
            "n_errors": self.n_errors,
            "n_rejected": self.n_rejected,
            "requests_by_kind": {
                k: sum(1 for r in done if r.kind == k)
                for k in sorted({r.kind for r in done})},
            "latency_s": _quantiles([r.latency_s for r in ok]),
            "ttfr_s": _quantiles([r.ttfr_s for r in ok]),
            "ticks": self.ticks,
            "device_gets": self.device_gets,
            "gen_ticks": self.gen_ticks,
            "ticks_by_lane": {k: v.ticks for k, v in self.per_lane.items()},
            "per_lane": {k: v.as_dict() for k, v in self.per_lane.items()},
            "slot_occupancy": (self.slots_used / self.slots_total
                               if self.slots_total else 0.0),
            "padded_waste_frac": (1.0 - self.slots_used / self.slots_total
                                  if self.slots_total else 0.0),
            "rows_priced": self.rows_priced,
            "busy_s": self.busy_s,
            "rows_per_sec_busy": (self.rows_priced / self.busy_s
                                  if self.busy_s > 0 else 0.0),
            "wall_s": time.perf_counter() - self.t_start,
        }
        if trace_stats is not None:
            snap["trace"] = dict(trace_stats)
            snap["recompiles_after_warmup"] = \
                trace_stats.get("tick_recompiles", 0)
        if cache_stats is not None:
            snap["result_cache"] = dict(cache_stats)
        return snap

    def write_json(self, path, trace_stats=None, cache_stats=None
                   ) -> pathlib.Path:
        path = pathlib.Path(path)
        path.write_text(json.dumps(
            self.snapshot(trace_stats, cache_stats), indent=2,
            sort_keys=True, default=float) + "\n")
        return path
