"""Low-overhead structured span tracer (the `repro_torch.obs` timing surface).

A copy of the JAX package's ``obs/trace.py``, which imports no JAX.

One process-wide :class:`Tracer` collects nestable, labeled spans —
``pack``, ``jit_compile``, ``kernel_dispatch``, ``device_get``,
``chunk``, ``generation``, ``tick`` — into a bounded ring buffer and
exports them two ways:

* :meth:`Tracer.export_chrome` — Chrome/Perfetto ``trace_event`` JSON
  (load the file at https://ui.perfetto.dev or ``chrome://tracing``);
* :meth:`Tracer.phase_table` — aggregate per-phase wall tables (count /
  total / mean / max seconds per span name), the form the benchmarks
  fold into ``BENCH_*.json``.

Tracing is **off by default and zero-cost when off**: ``span()`` is one
predicate check returning a shared no-op context manager, and nothing
else in the module runs.  Enable with ``REPRO_TRACE=1`` in the
environment (read at import) or :func:`enable` at runtime.  Nothing
here ever touches the device or forces a host sync — spans time
whatever the caller already does, they never add a ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import json
import os
import pathlib
import threading
import time
from collections import deque
from typing import Dict, List, Optional

_ENV_VAR = "REPRO_TRACE"
_TRUE = ("1", "true", "yes", "on")


def _env_enabled() -> bool:
    return os.environ.get(_ENV_VAR, "").strip().lower() in _TRUE


class _NullSpan:
    """Shared do-nothing context manager returned while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records a complete ("ph": "X") event on exit."""

    __slots__ = ("tracer", "name", "labels", "t0", "parent")

    def __init__(self, tracer: "Tracer", name: str, labels: Dict):
        self.tracer = tracer
        self.name = name
        self.labels = labels
        self.t0 = 0.0
        self.parent = None

    def __enter__(self):
        stack = self.tracer._stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        stack = self.tracer._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        self.tracer._record(self.name, self.t0, t1 - self.t0, self.parent,
                            self.labels)
        return False


class Tracer:
    """Bounded in-process span collector (see module docstring)."""

    def __init__(self, capacity: int = 500_000, enabled: bool = None):
        self.capacity = int(capacity)
        self._enabled = _env_enabled() if enabled is None else bool(enabled)
        self._events: deque = deque(maxlen=self.capacity)
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._local = threading.local()

    # -- state ---------------------------------------------------------------
    def enabled(self) -> bool:
        return self._enabled

    def enable(self, on: bool = True):
        self._enabled = bool(on)

    def clear(self):
        with self._lock:
            self._events.clear()

    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    # -- recording -----------------------------------------------------------
    def span(self, name: str, **labels):
        """Context manager timing a phase; no-op while tracing is off."""
        if not self._enabled:
            return _NULL_SPAN
        return _Span(self, name, labels)

    def _record(self, name: str, t0: float, dur_s: float,
                parent: Optional[str], labels: Dict):
        with self._lock:
            self._events.append((name, t0 - self._t0, dur_s, parent,
                                 labels or None))

    def add_complete(self, name: str, dur_s: float, t_end: float = None,
                     **labels):
        """Record an already-measured phase (probes that timed a call
        themselves); attributed to the innermost open span as parent."""
        if not self._enabled:
            return
        t1 = time.perf_counter() if t_end is None else t_end
        stack = self._stack()
        self._record(name, t1 - dur_s, dur_s,
                     stack[-1] if stack else None, labels)

    def instant(self, name: str, **labels):
        """Zero-duration marker event."""
        if not self._enabled:
            return
        stack = self._stack()
        self._record(name, time.perf_counter(), 0.0,
                     stack[-1] if stack else None, labels)

    # -- introspection -------------------------------------------------------
    def events(self) -> List[Dict]:
        """Snapshot of collected events as dicts (oldest first)."""
        with self._lock:
            raw = list(self._events)
        return [{"name": n, "t_s": ts, "dur_s": dur, "parent": parent,
                 "labels": labels or {}}
                for n, ts, dur, parent, labels in raw]

    def phase_table(self) -> Dict[str, Dict[str, float]]:
        """Aggregate wall per span name: count / total / mean / max (s)."""
        table: Dict[str, Dict[str, float]] = {}
        for ev in self.events():
            row = table.setdefault(ev["name"], {"count": 0, "total_s": 0.0,
                                                "max_s": 0.0})
            row["count"] += 1
            row["total_s"] += ev["dur_s"]
            row["max_s"] = max(row["max_s"], ev["dur_s"])
        for row in table.values():
            row["mean_s"] = row["total_s"] / row["count"]
        return table

    def coverage(self, parent: str = "tick") -> float:
        """Fraction of ``parent`` span wall accounted for by its direct
        child spans — the "do the spans explain the tick?" check."""
        parent_s = child_s = 0.0
        for ev in self.events():
            if ev["name"] == parent:
                parent_s += ev["dur_s"]
            elif ev["parent"] == parent:
                child_s += ev["dur_s"]
        return child_s / parent_s if parent_s > 0 else 0.0

    def trace_tree(self, trace_id: str) -> List[Dict]:
        """Every recorded event belonging to one request's trace.

        A span/instant belongs to trace ``X`` when its labels carry
        ``trace_id == X`` (request-scoped events: ``request_admit``,
        ``request_done``, ``admission_compile``, …) or when ``X`` is in
        its ``trace_ids`` label (shared events: a coalesced ``tick``
        span lists every request that rode it).  Events come back
        oldest-first, so admission → ticks → terminal reads in causal
        order and ``export_chrome`` of the same ring shows the tree.
        """
        out = []
        for ev in self.events():
            labels = ev["labels"]
            if labels.get("trace_id") == trace_id or \
                    trace_id in (labels.get("trace_ids") or ()):
                out.append(ev)
        return out

    def count(self, name: str, parent: Optional[str] = "__any__") -> int:
        """Number of recorded ``name`` events, optionally restricted to
        those nested under ``parent``."""
        return sum(1 for ev in self.events()
                   if ev["name"] == name
                   and (parent == "__any__" or ev["parent"] == parent))

    # -- export --------------------------------------------------------------
    def chrome_events(self) -> List[Dict]:
        """Events in Chrome ``trace_event`` form (complete "X" phases,
        microsecond timestamps)."""
        tid = threading.get_ident() % 2 ** 31
        out = []
        for ev in self.events():
            args = dict(ev["labels"])
            if ev["parent"]:
                args["parent"] = ev["parent"]
            out.append({"name": ev["name"], "ph": "X", "cat": "repro",
                        "ts": ev["t_s"] * 1e6, "dur": ev["dur_s"] * 1e6,
                        "pid": os.getpid(), "tid": tid, "args": args})
        return out

    def export_chrome(self, path) -> pathlib.Path:
        """Write the ring as a Chrome/Perfetto ``trace_event`` JSON file."""
        path = pathlib.Path(path)
        payload = {"traceEvents": self.chrome_events(),
                   "displayTimeUnit": "ms"}
        path.write_text(json.dumps(payload, default=float) + "\n")
        return path


# The process-wide tracer every instrumented module shares.
TRACER = Tracer()


def enabled() -> bool:
    """Is tracing currently on (``REPRO_TRACE=1`` or ``enable()``)?"""
    return TRACER.enabled()


def span(name: str, **labels):
    """``with span("tick"): ...`` on the shared tracer."""
    return TRACER.span(name, **labels)
