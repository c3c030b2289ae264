"""Stuck-tick watchdog: a heartbeat thread with a one-shot-per-stall
callback (a copy of the JAX package's ``resilience/watchdog.py``).

The watchdog thread reads two host fields and calls the callback; it
never touches CUDA.  The service brackets every tick with ``enter()`` /
``exit()``; the watchdog thread polls and, when a tick has been in flight longer than
``timeout_s``, fires ``on_stall(elapsed_s)`` exactly once for that tick
(the trip latch re-arms on ``exit()``).  The callback runs on the
watchdog thread — it cannot preempt the blocked tick (CPython offers no
safe way to kill a thread mid-dispatch), so its job is evidence and
escalation: the service uses it to auto-dump the flight recorder, and
the tick loop itself is restart-safe (escaped exceptions are contained
per tick, and a dead loop task is relaunched on the next submit).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class Watchdog:
    def __init__(self, timeout_s: float,
                 on_stall: Callable[[float], None],
                 poll_s: Optional[float] = None):
        if timeout_s <= 0:
            raise ValueError(f"watchdog timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.on_stall = on_stall
        self.poll_s = float(poll_s) if poll_s is not None \
            else max(0.01, self.timeout_s / 4.0)
        self.trips = 0
        self._busy_since: Optional[float] = None
        self._tripped = False        # latch: one trip per enter/exit pair
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._poll, name="repro-watchdog", daemon=True)
        self._thread.start()

    def stop(self):
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._thread = None

    def enter(self):
        """A tick is starting."""
        self._tripped = False
        self._busy_since = time.monotonic()

    def exit(self):
        """The tick finished (however it ended)."""
        self._busy_since = None
        self._tripped = False

    def _poll(self):
        while not self._stop.wait(self.poll_s):
            since = self._busy_since
            if since is None or self._tripped:
                continue
            elapsed = time.monotonic() - since
            if elapsed < self.timeout_s:
                continue
            # Latch before the callback: a slow on_stall must not
            # double-fire for the same stuck tick.
            self._tripped = True
            self.trips += 1
            try:
                self.on_stall(elapsed)
            except Exception:  # noqa: BLE001 - watchdog must survive
                pass

    def snapshot(self) -> dict:
        since = self._busy_since
        return {
            "timeout_s": self.timeout_s,
            "trips": self.trips,
            "busy_for_s": (round(time.monotonic() - since, 6)
                           if since is not None else None),
            "running": self._thread is not None,
        }
