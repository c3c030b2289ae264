"""Service flight recorder: a bounded ring buffer of recent ticks and
request lifecycle events, dumpable as a Chrome/Perfetto trace file.
A copy of the JAX package's ``obs/flight.py``.

Unlike the span tracer (off by default, timing-oriented), the flight
recorder is **always on and allocation-bounded**: the
:class:`~repro_torch.service.server.PricingService` records every tick and
request event into the ring, so when something goes wrong there is a
recent-history black box to dump — on demand via
``PricingService.dump_flight_recorder()``, or automatically on a tick
failure when ``REPRO_FLIGHT_DIR`` points at a directory.  Recording one
event is a deque append of a small tuple; nothing is serialized until a
dump is requested.
"""
from __future__ import annotations

import json
import os
import pathlib
import time
from collections import deque
from typing import Dict, List, Optional

_ENV_DIR = "REPRO_FLIGHT_DIR"


class FlightRecorder:
    """Bounded ring of ``(t, event, fields)`` records (see module
    docstring).

    Event conventions used by the service: ``tick`` (with
    lane/slots/used/rows/wall_s), ``request`` / ``request_error`` (with
    uid/kind), and ``tick_error`` (with lane/error).  Durationful events
    carry their wall in a ``wall_s`` field and export as complete trace
    events; everything else exports as instants.
    """

    def __init__(self, capacity: int = 2048):
        self.capacity = int(capacity)
        self._events: deque = deque(maxlen=self.capacity)
        self._t0 = time.perf_counter()
        self.n_recorded = 0          # total ever, beyond the ring bound
        self.n_dumps = 0

    def record(self, event: str, **fields):
        """Record one ``event`` (the event name is positional-only by
        convention so ``fields`` can freely carry a ``kind`` key)."""
        self._events.append((time.perf_counter() - self._t0, event, fields))
        self.n_recorded += 1

    def records(self, event: Optional[str] = None) -> List[Dict]:
        return [{"t_s": t, "event": k, **f}
                for t, k, f in list(self._events)
                if event is None or k == event]

    def clear(self):
        self._events.clear()

    def __len__(self) -> int:
        return len(self._events)

    # -- export --------------------------------------------------------------
    def chrome_events(self) -> List[Dict]:
        """The ring as Chrome ``trace_event`` dicts: events that carry a
        ``wall_s`` become complete ("X") spans ending at their record
        time, the rest become instants ("i")."""
        pid = os.getpid()
        out = []
        for t, event, fields in list(self._events):
            args = {k: v for k, v in fields.items() if k != "wall_s"}
            wall = fields.get("wall_s")
            if wall is not None:
                out.append({"name": event, "ph": "X", "cat": "flight",
                            "ts": (t - wall) * 1e6, "dur": wall * 1e6,
                            "pid": pid, "tid": 1, "args": args})
            else:
                out.append({"name": event, "ph": "i", "cat": "flight",
                            "ts": t * 1e6, "s": "t", "pid": pid, "tid": 1,
                            "args": args})
        return out

    def dump(self, path=None, extra_events: Optional[List[Dict]] = None
             ) -> pathlib.Path:
        """Write the ring (plus optional extra trace events, e.g. the span
        tracer's) as one ``trace_event`` JSON file.  Default filename:
        ``flight_<pid>.json`` under ``REPRO_FLIGHT_DIR`` or the cwd."""
        if path is None:
            base = pathlib.Path(os.environ.get(_ENV_DIR) or ".")
            path = base / f"flight_{os.getpid()}_{self.n_dumps}.json"
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        events = self.chrome_events() + list(extra_events or [])
        path.write_text(json.dumps(
            {"traceEvents": events, "displayTimeUnit": "ms"},
            default=float) + "\n")
        self.n_dumps += 1
        return path

    @staticmethod
    def auto_dump_dir() -> Optional[str]:
        """Directory for automatic on-error dumps (``REPRO_FLIGHT_DIR``),
        or None when auto-dumping is disabled."""
        d = os.environ.get(_ENV_DIR, "").strip()
        return d or None
