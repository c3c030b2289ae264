"""SLO / error-budget tracking for the pricing service.

A copy of the JAX package's ``obs/slo.py``.

Objectives are declarative: an :class:`SLObjective` names a request
kind (or ``"*"`` for all kinds), a latency target ("99% of requests
answer within 250 ms") and/or an availability target ("99.9% of
requests succeed"), over a sliding window.  :class:`SLOTracker` consumes
the same terminal stream the serving-cost ledger closes bills from and
maintains, per objective:

* the window's bad-event fractions (latency violations, errors);
* the **burn rate** — bad fraction divided by the error budget
  ``1 - target``.  Burn 1.0 means "spending budget exactly as fast as
  the objective allows"; sustained burn above ``alert_burn_rate``
  means the budget will be exhausted early.

When a burn rate crosses its alert threshold the tracker latches a
burn event (one per excursion, not one per request) and invokes the
``on_burn`` callback — the service wires that to the flight recorder so
a budget burn auto-dumps the last N seconds of context, with the
offending ``trace_id`` attached.  Burn rates and violation counts are
mirrored into the metrics registry as ``slo_*`` gauges/counters.

Pure host-side bookkeeping: O(1) per observation amortized, no device
work, safe to leave enabled in production.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .registry import REGISTRY, Registry


@dataclasses.dataclass(frozen=True)
class SLObjective:
    """One declarative objective for a request kind (``"*"`` = any)."""

    kind: str = "*"
    latency_ms: Optional[float] = None    # per-request latency target
    latency_target: float = 0.99          # fraction that must meet it
    availability: Optional[float] = None  # fraction that must succeed
    window_s: float = 60.0
    alert_burn_rate: float = 1.0

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _Window:
    """Sliding window of terminal events for one objective."""

    objective: SLObjective
    events: deque = dataclasses.field(default_factory=deque)
    # events hold (t, latency_bad, error_bad, trace_id)
    latency_violations: int = 0     # lifetime counts (monotonic)
    errors: int = 0
    burn_events: int = 0
    burning: Dict[str, bool] = dataclasses.field(
        default_factory=lambda: {"latency": False, "availability": False})


def _metric_kind(kind: str) -> str:
    return "all" if kind == "*" else kind


class SLOTracker:
    """Feed terminal request outcomes; read burn rates (see module doc)."""

    def __init__(self, objectives: Sequence[SLObjective],
                 registry: Optional[Registry] = None,
                 on_burn: Optional[Callable] = None):
        self._registry = registry if registry is not None else REGISTRY
        self._on_burn = on_burn
        self._windows: List[_Window] = [
            _Window(objective=o) for o in objectives]
        self.observed = 0

    def __bool__(self) -> bool:
        return bool(self._windows)

    def objectives(self) -> List[SLObjective]:
        return [w.objective for w in self._windows]

    # -- ingestion -----------------------------------------------------------
    def observe(self, kind: str, latency_s: float, ok: bool,
                trace_id: str = "", now: Optional[float] = None):
        """Record one terminal outcome against every matching objective."""
        self.observed += 1
        t = time.monotonic() if now is None else float(now)
        latency_ms = float(latency_s) * 1e3
        for w in self._windows:
            o = w.objective
            if o.kind != "*" and o.kind != kind:
                continue
            latency_bad = (o.latency_ms is not None
                           and latency_ms > o.latency_ms)
            error_bad = not ok
            w.events.append((t, latency_bad, error_bad, trace_id))
            if latency_bad:
                w.latency_violations += 1
            if error_bad:
                w.errors += 1
            self._prune(w, t)
            self._evaluate(w, trace_id)

    @staticmethod
    def _prune(w: _Window, now: float):
        horizon = now - w.objective.window_s
        while w.events and w.events[0][0] < horizon:
            w.events.popleft()

    # -- burn math -----------------------------------------------------------
    @staticmethod
    def _burn(bad: int, n: int, target: Optional[float]) -> float:
        """bad-fraction / error-budget; 0 when the objective is absent."""
        if target is None or not n:
            return 0.0
        budget = max(1.0 - float(target), 1e-9)
        return (bad / n) / budget

    def _rates(self, w: _Window) -> Tuple[float, float]:
        n = len(w.events)
        lat_bad = sum(1 for _, lb, _, _ in w.events if lb)
        err_bad = sum(1 for _, _, eb, _ in w.events if eb)
        o = w.objective
        lat_target = o.latency_target if o.latency_ms is not None else None
        return (self._burn(lat_bad, n, lat_target),
                self._burn(err_bad, n, o.availability))

    def _evaluate(self, w: _Window, trace_id: str):
        lat_burn, avail_burn = self._rates(w)
        o, mk = w.objective, _metric_kind(w.objective.kind)
        reg = self._registry
        reg.gauge(f"slo_{mk}_latency_burn",
                  help="latency error-budget burn rate").set(lat_burn)
        reg.gauge(f"slo_{mk}_availability_burn",
                  help="availability error-budget burn rate").set(avail_burn)
        reg.counter(f"slo_{mk}_latency_violations").value = \
            float(w.latency_violations)
        reg.counter(f"slo_{mk}_errors").value = float(w.errors)
        for dim, burn in (("latency", lat_burn),
                          ("availability", avail_burn)):
            over = burn >= o.alert_burn_rate and burn > 0.0
            if over and not w.burning[dim]:
                w.burning[dim] = True
                w.burn_events += 1
                reg.counter("slo_burn_events",
                            help="error-budget burn excursions").inc()
                if self._on_burn is not None:
                    self._on_burn(o.kind, dim, burn, trace_id)
            elif not over and w.burning[dim]:
                w.burning[dim] = False   # excursion over; re-arm the latch

    # -- introspection -------------------------------------------------------
    def snapshot(self) -> Dict:
        out = {}
        for w in self._windows:
            lat_burn, avail_burn = self._rates(w)
            out[_metric_kind(w.objective.kind)] = {
                "objective": w.objective.as_dict(),
                "window_n": len(w.events),
                "latency_burn": lat_burn,
                "availability_burn": avail_burn,
                "latency_violations": w.latency_violations,
                "errors": w.errors,
                "burn_events": w.burn_events,
                "burning": any(w.burning.values()),
            }
        return out
