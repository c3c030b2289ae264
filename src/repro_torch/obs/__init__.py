"""repro_torch.obs — stack-wide observability: span tracing, metrics,
first-call attribution and the service flight recorder (the counterpart
of ``repro.obs``).

* :mod:`repro_torch.obs.trace` — nestable labeled spans, exportable as
  Chrome/Perfetto ``trace_event`` JSON and aggregate per-phase wall
  tables;
* :mod:`repro_torch.obs.registry` — named counters/gauges/histograms
  with JSON + Prometheus-style text exposition;
* :mod:`repro_torch.obs.torchhooks` — per-signature first-call vs
  dispatch attribution of the module-level entry points, and
  :func:`~repro_torch.obs.torchhooks.to_host`, the counted
  device-to-host copy;
* :mod:`repro_torch.obs.flight` — the service's bounded black-box ring,
  dumped as a trace file on error or on demand;
* :mod:`repro_torch.obs.ledger` — per-request serving-cost bills;
* :mod:`repro_torch.obs.slo` — declarative latency/availability
  objectives with sliding-window error-budget burn rates.

Tracing is **off by default**; turn it on with ``REPRO_TRACE=1`` in the
environment or :func:`enable`.  It never adds a host sync.  Unlike the
reference, enabling it patches nothing: the probes and ``to_host`` read
the tracer's switch themselves.
"""
from __future__ import annotations

from . import torchhooks
from .flight import FlightRecorder
from .ledger import Bill, Ledger
from .registry import (Counter, Gauge, Histogram, REGISTRY, Registry,
                       TraceCounts)
from .slo import SLObjective, SLOTracker
from .trace import TRACER, Tracer, span

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY", "TraceCounts",
    "Tracer", "TRACER", "span", "FlightRecorder", "torchhooks",
    "Bill", "Ledger", "SLObjective", "SLOTracker",
    "enabled", "enable", "disable", "export_chrome", "phase_table",
]


def enabled() -> bool:
    """Is the observability layer currently recording?"""
    return TRACER.enabled()


def enable(on: bool = True):
    """Turn span tracing (and with it the probes' timing and the
    ``device_get`` spans) on or off at runtime — the programmatic twin of
    ``REPRO_TRACE=1``."""
    TRACER.enable(on)


def disable():
    enable(False)


def export_chrome(path):
    """Write everything the span tracer collected as a Chrome/Perfetto
    ``trace_event`` JSON file."""
    return TRACER.export_chrome(path)


def phase_table():
    """Aggregate per-phase wall table (count/total/mean/max seconds)."""
    return TRACER.phase_table()
