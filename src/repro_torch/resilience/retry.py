"""Retry-with-backoff and a circuit breaker for the fused-dispatch path.

A copy of the JAX package's ``resilience/retry.py``.

Both are host-side and synchronous: the service tick loop is single-
threaded by design (one lane, one dispatch, one device-to-host copy
per tick), so the breaker needs no locking — it is a small state machine
advanced by the tick that owns it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """``retries`` extra attempts after the first, sleeping
    ``backoff_s * attempt`` before retry ``attempt`` (linear backoff —
    the retry budget here is 1-2 attempts, not a remote-API ladder)."""

    retries: int = 1
    backoff_s: float = 0.005


def call_with_retry(fn: Callable, policy: RetryPolicy = RetryPolicy(),
                    on_retry: Optional[Callable[[int, BaseException], None]] = None,
                    sleep: Callable[[float], None] = time.sleep):
    """Call ``fn()``; on exception retry up to ``policy.retries`` times.

    ``on_retry(attempt, error)`` observes each failed attempt (1-based).
    The last error re-raises once the budget is spent.
    """
    attempts = 1 + max(0, policy.retries)
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - retry means "any failure"
            if on_retry is not None:
                on_retry(attempt, e)
            if attempt == attempts:
                raise
            sleep(policy.backoff_s * attempt)


class CircuitBreaker:
    """closed -> open -> half_open fused-path gate.

    * **closed**: traffic flows; ``threshold`` *consecutive* failures
      open the breaker.
    * **open**: ``allow()`` returns False until ``cooldown_s`` has
      elapsed, then transitions to **half_open** and admits exactly one
      probe.
    * **half_open**: the probe's ``record_success`` closes the breaker,
      its ``record_failure`` re-opens (and restarts the cool-down).

    ``clock`` is injectable for tests; ``on_event`` observes
    ``"open"`` / ``"close"`` / ``"probe"`` transitions.  ``open_s_total``
    accumulates wall spent open/half_open — the recovery-latency metric
    chaos benches report.
    """

    def __init__(self, threshold: int = 1, cooldown_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic,
                 on_event: Optional[Callable[[str], None]] = None):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self.on_event = on_event
        self.state = "closed"
        self.failures = 0           # consecutive, resets on success
        self.opened_at: Optional[float] = None
        self._cooldown_from: Optional[float] = None
        self.opens = 0
        self.closes = 0
        self.probes = 0
        self.open_s_total = 0.0
        self.last_open_s: Optional[float] = None

    def _emit(self, event: str):
        if self.on_event is not None:
            self.on_event(event)

    def allow(self) -> bool:
        """May the protected path be attempted right now?"""
        if self.state == "closed":
            return True
        if self.state == "open":
            if self.clock() - self._cooldown_from < self.cooldown_s:
                return False
            self.state = "half_open"
            self.probes += 1
            self._emit("probe")
            return True
        # half_open: one probe is already in flight this tick; the tick
        # loop is serial so a second allow() before its verdict means
        # the probe tick itself re-entered — let it through.
        return True

    def record_success(self):
        self.failures = 0
        if self.state != "closed":
            self.state = "closed"
            self.closes += 1
            dt = self.clock() - self.opened_at
            self.open_s_total += dt
            self.last_open_s = dt
            self.opened_at = None
            self._emit("close")

    def record_failure(self):
        self.failures += 1
        if self.state == "closed" and self.failures < self.threshold:
            return
        # half_open probe failed, or threshold reached: (re)open and
        # restart the cool-down window from now.  opened_at keeps the
        # *original* open time so open-duration accounting spans failed
        # probes.
        if self.opened_at is None:
            self.opened_at = self.clock()
        if self.state != "open":
            self.state = "open"
            self.opens += 1
            self._emit("open")
        self._cooldown_from = self.clock()

    def snapshot(self) -> dict:
        out = {
            "state": self.state,
            "consecutive_failures": self.failures,
            "opens": self.opens,
            "closes": self.closes,
            "probes": self.probes,
            "open_s_total": round(self.open_s_total, 6),
            "last_open_s": (round(self.last_open_s, 6)
                            if self.last_open_s is not None else None),
        }
        if self.opened_at is not None:
            out["open_for_s"] = round(self.clock() - self.opened_at, 6)
        return out
