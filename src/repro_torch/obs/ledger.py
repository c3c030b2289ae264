"""Serving-cost ledger: per-request resource bills for the pricing service.

A copy of the JAX package's ``obs/ledger.py``.

The service coalesces many requests into one fused dispatch per tick, so
"what did *this* request cost to serve" is not directly measurable — the
device prices a padded batch and every rider shares the wall.  The
ledger closes that gap with an explicit accounting model:

* :meth:`Ledger.open` mints a :class:`Bill` at admission (one per
  request uid, keyed by its ``trace_id``);
* :meth:`Ledger.charge_tick` pro-rates one tick's measured wall across
  the requests that rode it, **by rows contributed**: a request that
  contributed 96 of a tick's 128 priced rows pays 75% of the tick's
  device ms, of its probe-attributed dispatch ms, and of its padded
  waste (``wall * (1 - used/slots)``);
* :meth:`Ledger.close` finalizes the bill at the terminal path (ok,
  typed error, cached, cancelled) with latency, cache/degraded/replay
  provenance and mirrors it into the metrics registry — including a
  ``ledger_request_device_ms`` histogram carrying the request's
  ``trace_id`` as an exemplar.

Two invariants are tracked continuously and exposed as registry gauges
so benchmarks and CI can assert them:

* **sum-to-wall**: the shares charged for a tick sum to that tick's
  measured wall; ``ledger_tick_residual_rel`` records the worst
  relative residual seen (float rounding only, so ~1e-9 in practice);
* **no unattributed time**: a tick whose plan named no payers books its
  wall into ``ledger_unattributed_ms`` — the service never produces one
  on the bench, and the regression guard pins the counter at zero.

Aggregates (per request kind and per lane) accumulate at charge/close
time, not at snapshot time, so late charges after a failure-path close
still land in the cost-per-query rollup.  The ledger is independent of
tracing: bills are charged from the tick wall the server already
measures, so the untraced hot path stays untraced.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from .registry import REGISTRY, Registry


@dataclasses.dataclass
class Bill:
    """One request's resource bill, accumulated across the ticks it rode."""

    trace_id: str
    uid: int
    kind: str
    replayed: bool = False
    status: str = "open"          # open | ok | cancelled | <error code>
    ticks: int = 0                # coalesced ticks this request rode
    rows_priced: int = 0          # rows it contributed across those ticks
    device_ms: float = 0.0        # pro-rated share of measured tick wall
    dispatch_ms: float = 0.0      # share of probe-attributed dispatch wall
    padded_ms: float = 0.0        # share of padded-slot waste
    retries: int = 0              # tick retries this request rode through
    degraded_rows: int = 0        # rows answered via the legacy fallback
    cache_hit: bool = False
    latency_ms: float = 0.0

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _KindAgg:
    requests: int = 0
    ok: int = 0
    errors: int = 0
    cache_hits: int = 0
    replayed: int = 0
    rows_priced: int = 0
    device_ms: float = 0.0
    dispatch_ms: float = 0.0
    padded_ms: float = 0.0
    retries: int = 0
    degraded_rows: int = 0


@dataclasses.dataclass
class _LaneAgg:
    ticks: int = 0
    wall_ms: float = 0.0
    rows_priced: int = 0
    padded_ms: float = 0.0
    dispatch_ms: float = 0.0


class Ledger:
    """Bill store + tick-share accountant (see module docstring)."""

    def __init__(self, registry: Optional[Registry] = None,
                 keep_closed: int = 512):
        self._registry = registry if registry is not None else REGISTRY
        self._lock = threading.Lock()
        self._open: Dict[int, Bill] = {}
        self._closed: List[Bill] = []
        self._keep_closed = int(keep_closed)
        self._by_kind: Dict[str, _KindAgg] = {}
        self._by_lane: Dict[str, _LaneAgg] = {}
        self.ticks_charged = 0
        self.device_ms_total = 0.0
        self.unattributed_ms = 0.0
        self.tick_residual_rel_max = 0.0
        self.closed_total = 0

    # -- lifecycle -----------------------------------------------------------
    def open(self, trace_id: str, uid: int, kind: str,
             replayed: bool = False) -> Bill:
        bill = Bill(trace_id=trace_id, uid=int(uid), kind=str(kind),
                    replayed=bool(replayed))
        with self._lock:
            self._open[bill.uid] = bill
        return bill

    def charge_tick(self, lane: str, wall_s: float,
                    parts: Sequence[Tuple[Bill, int]], slots: int, used: int,
                    dispatch_s: float = 0.0, retries: int = 0):
        """Split one tick's measured wall across its riders by rows.

        ``parts`` is ``[(bill, rows_contributed)]`` — one entry per
        distinct request (callers aggregate multiple slot assignments of
        the same owner first).  The last rider absorbs the rounding
        remainder so the shares sum to ``wall_s`` exactly.
        """
        wall_ms = float(wall_s) * 1e3
        dispatch_ms = float(dispatch_s) * 1e3
        slots = max(int(slots), 1)
        padded_frac = max(0.0, 1.0 - float(used) / slots)
        total_rows = sum(max(int(n), 0) for _, n in parts)
        with self._lock:
            self.ticks_charged += 1
            lane_agg = self._by_lane.setdefault(lane, _LaneAgg())
            lane_agg.ticks += 1
            lane_agg.wall_ms += wall_ms
            lane_agg.rows_priced += total_rows
            lane_agg.padded_ms += wall_ms * padded_frac
            lane_agg.dispatch_ms += dispatch_ms
            if total_rows <= 0 or not parts:
                self.unattributed_ms += wall_ms
                self._mirror_invariants()
                return
            charged = 0.0
            for i, (bill, rows) in enumerate(parts):
                rows = max(int(rows), 0)
                if i == len(parts) - 1:
                    share = wall_ms - charged   # remainder-absorbing
                else:
                    share = wall_ms * rows / total_rows
                charged += share
                bill.ticks += 1
                bill.rows_priced += rows
                bill.device_ms += share
                bill.dispatch_ms += dispatch_ms * rows / total_rows
                bill.padded_ms += share * padded_frac
                bill.retries += int(retries)
                kind_agg = self._by_kind.setdefault(bill.kind, _KindAgg())
                kind_agg.rows_priced += rows
                kind_agg.device_ms += share
                kind_agg.dispatch_ms += dispatch_ms * rows / total_rows
                kind_agg.padded_ms += share * padded_frac
                kind_agg.retries += int(retries)
            self.device_ms_total += wall_ms
            residual = abs(charged - wall_ms)
            rel = residual / wall_ms if wall_ms > 0 else 0.0
            self.tick_residual_rel_max = max(self.tick_residual_rel_max, rel)
            self._mirror_invariants()

    def close(self, bill: Bill, status: str = "ok", cache_hit: bool = False,
              degraded_rows: int = 0, latency_s: float = 0.0):
        """Finalize a bill at its terminal path; idempotent per uid."""
        with self._lock:
            was_open = self._open.pop(bill.uid, None) is not None
            if not was_open and bill.status != "open":
                return                     # already closed (double terminal)
            bill.status = str(status)
            bill.cache_hit = bool(cache_hit)
            bill.degraded_rows = int(degraded_rows)
            bill.latency_ms = float(latency_s) * 1e3
            self.closed_total += 1
            self._closed.append(bill)
            if len(self._closed) > self._keep_closed:
                del self._closed[: len(self._closed) - self._keep_closed]
            agg = self._by_kind.setdefault(bill.kind, _KindAgg())
            agg.requests += 1
            agg.ok += 1 if bill.status == "ok" else 0
            agg.errors += 0 if bill.status in ("ok", "cancelled") else 1
            agg.cache_hits += 1 if bill.cache_hit else 0
            agg.replayed += 1 if bill.replayed else 0
            agg.degraded_rows += bill.degraded_rows
        reg = self._registry
        reg.counter("ledger_bills_closed",
                    help="requests with a finalized cost bill").inc()
        if bill.cache_hit:
            reg.counter("ledger_bills_cached").inc()
        reg.counter("ledger_rows_priced").inc(max(bill.rows_priced, 0))
        reg.histogram("ledger_request_device_ms",
                      help="per-request pro-rated device ms").observe(
            bill.device_ms, exemplar=bill.trace_id)

    def _mirror_invariants(self):
        # called under self._lock; gauge writes are cheap and lock-free
        reg = self._registry
        reg.counter("ledger_ticks_charged",
                    help="ticks whose wall was billed to riders").inc()
        reg.gauge("ledger_tick_residual_rel",
                  help="worst |billed-wall|/wall across ticks").set(
            self.tick_residual_rel_max)
        reg.gauge("ledger_unattributed_ms",
                  help="tick wall with no request to bill").set(
            self.unattributed_ms)
        reg.gauge("ledger_device_ms_total").set(self.device_ms_total)

    # -- introspection -------------------------------------------------------
    def bill_for(self, uid: int) -> Optional[Bill]:
        with self._lock:
            b = self._open.get(uid)
            if b is not None:
                return b
            for bill in reversed(self._closed):
                if bill.uid == uid:
                    return bill
        return None

    def snapshot(self) -> Dict:
        """JSON-ready rollup: invariants + per-kind / per-lane aggregates."""
        with self._lock:
            by_kind = {}
            for kind, agg in sorted(self._by_kind.items()):
                row = dataclasses.asdict(agg)
                row["device_ms_per_query"] = (
                    agg.device_ms / agg.requests if agg.requests else 0.0)
                by_kind[kind] = row
            by_lane = {lane: dataclasses.asdict(agg)
                       for lane, agg in sorted(self._by_lane.items())}
            return {
                "open": len(self._open),
                "closed": self.closed_total,
                "ticks_charged": self.ticks_charged,
                "device_ms_total": self.device_ms_total,
                "tick_residual_rel_max": self.tick_residual_rel_max,
                "unattributed_ms": self.unattributed_ms,
                "by_kind": by_kind,
                "by_lane": by_lane,
            }
