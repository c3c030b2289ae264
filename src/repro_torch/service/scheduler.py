"""The coalescing scheduler: pending request spans -> constant-shape ticks.

A copy of the JAX package's ``service/scheduler.py``: the same requests
in the same order give the same tick plans.

Policy only — no device work, no asyncio — so the scheduling behavior is
unit-testable in isolation.  The server owns the loop; the scheduler owns
*what runs next*:

* Work arrives as :class:`SpanWork` (an index sweep, divisible),
  :class:`GroupWork` (a raw ``share_nre`` system group, indivisible — its
  NRE amortization needs the whole group in one batch), or
  :class:`GenWork` (one evolutionary-search state, one generation per
  tick).
* Every tick serves exactly ONE lane (one argument signature): the lane of
  the oldest queued item.  Same-lane work anywhere in the queue is
  coalesced into the tick's fixed slot budget — that is the continuous
  batching.
* **Fairness** is FIFO with large-request splitting: one item
  contributes at most ``split`` candidates per pass, and items that
  still have work left after a tick are rotated to the back of the
  queue.  A 1M-candidate sweep therefore yields a slot share to every
  point query that arrives behind it instead of starving the queue.
* **Backpressure** is a bounded row budget: :meth:`admit` refuses work
  past ``max_pending`` rows (the server turns that refusal into a typed
  ``queue_full`` error envelope, never an OOM).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Lane:
    """One argument-signature equivalence class: requests in the same lane may
    share a device tick.

    ``mc`` folds in everything two Monte-Carlo sweeps must agree on to
    share a chunk: the static trace key (draws, quantiles) AND the traced
    per-chunk arguments (seed, sigmas) — a chunk has one key/sigma set,
    so requests under different scenarios must not coalesce."""

    kind: str                      # "chunk" | "mc" | "raw" | "gen"
    flow: str = "chip-last"
    mc: Optional[Tuple] = None     # (draws, quantiles, seed, sigmas)


@dataclasses.dataclass(eq=False)        # identity semantics: queue
class SpanWork:                          # membership must not compare arrays
    """A divisible index sweep owned by one request."""

    owner: Any                     # the server's ActiveRequest
    lane: Lane
    idx: np.ndarray                # (n,) candidate indices, request order
    cursor: int = 0                # next unscheduled position
    deadline_t: Optional[float] = None   # absolute perf_counter deadline
    trace_id: str = ""             # the owning request's trace id

    @property
    def remaining(self) -> int:
        return int(self.idx.shape[0]) - self.cursor


@dataclasses.dataclass(eq=False)
class GroupWork:
    """An indivisible raw system group (one share_nre group, one tick)."""

    owner: Any
    lane: Lane
    systems: List[Any]             # core.system.System objects
    deadline_t: Optional[float] = None
    trace_id: str = ""             # the owning request's trace id

    @property
    def n_systems(self) -> int:
        return len(self.systems)


@dataclasses.dataclass(eq=False)
class GenWork:
    """One in-flight evolutionary search; the server's SearchTask holds
    the device-side population state."""

    owner: Any
    lane: Lane
    task: Any                      # server.SearchTask
    deadline_t: Optional[float] = None
    trace_id: str = ""             # the owning request's trace id


@dataclasses.dataclass
class Assignment:
    """One contiguous span of a SpanWork mapped into tick slots."""

    item: SpanWork
    start: int                     # offset into the request's row space
    n: int
    slot: int                      # first slot in the tick's chunk


@dataclasses.dataclass
class TickPlan:
    """Everything the server needs to dispatch one device tick."""

    lane: Lane
    slots: int                     # the lane's fixed slot budget
    used: int
    assignments: List[Assignment] = dataclasses.field(default_factory=list)
    groups: List[GroupWork] = dataclasses.field(default_factory=list)
    gen: Optional[GenWork] = None


class Scheduler:
    def __init__(self, slots: int, split: Optional[int] = None,
                 raw_slots: int = 16, max_pending: int = 1_000_000):
        if slots < 1:
            raise ValueError("need at least one chunk slot")
        self.slots = int(slots)
        self.split = int(split) if split else int(slots)
        if self.split < 1:
            raise ValueError("split must be positive")
        self.raw_slots = int(raw_slots)
        self.max_pending = int(max_pending)
        self.queue: deque = deque()
        self.pending_rows = 0

    # -- admission / backpressure -------------------------------------------
    def admit(self, items: List[Any], cost_rows: int) -> bool:
        """Enqueue ``items`` if the row budget allows; False = reject
        (the caller owes the client a ``queue_full`` envelope)."""
        if self.pending_rows + cost_rows > self.max_pending:
            return False
        self.pending_rows += cost_rows
        self.queue.extend(items)
        return True

    def push(self, item: Any):
        """Re-enqueue follow-on work whose budget was charged at admit
        time (search rank sweeps, continuing generations)."""
        self.queue.append(item)

    def release(self, rows: int):
        self.pending_rows = max(0, self.pending_rows - rows)

    def has_work(self) -> bool:
        return bool(self.queue)

    def drop_owned_by(self, owner: Any):
        """Remove all queued work of a (failed) request."""
        self.queue = deque(w for w in self.queue if w.owner is not owner)

    def clear(self):
        """Drop everything (simulated crash / hard shutdown): the queue
        empties and the whole row budget is released in one stroke."""
        self.queue.clear()
        self.pending_rows = 0

    def expire(self, now: float) -> List[Any]:
        """Pop and return every queued item whose deadline has passed
        (the caller owes each owner a ``deadline_exceeded`` envelope).
        Policy only: the row budget stays charged until the server fails
        the owner and releases it."""
        expired = [w for w in self.queue
                   if w.deadline_t is not None and w.deadline_t <= now]
        if expired:
            dead = {id(w) for w in expired}
            self.queue = deque(w for w in self.queue if id(w) not in dead)
        return expired

    # -- tick planning -------------------------------------------------------
    def plan(self) -> Optional[TickPlan]:
        if not self.queue:
            return None
        lane = self.queue[0].lane
        if lane.kind == "gen":
            return TickPlan(lane=lane, slots=1, used=1,
                            gen=self.queue.popleft())
        if lane.kind == "raw":
            return self._plan_raw(lane)
        return self._plan_spans(lane)

    def _plan_raw(self, lane: Lane) -> TickPlan:
        groups, used = [], 0
        for item in list(self.queue):
            if item.lane != lane:
                continue
            if used + item.n_systems > self.raw_slots and groups:
                break
            groups.append(item)
            used += item.n_systems
            if used >= self.raw_slots:
                break
        for g in groups:
            self.queue.remove(g)
        return TickPlan(lane=lane, slots=self.raw_slots, used=used,
                        groups=groups)

    def _plan_spans(self, lane: Lane) -> TickPlan:
        assignments: List[Assignment] = []
        served: List[SpanWork] = []
        used = 0
        # multi-pass fill: each pass hands every same-lane item at most
        # `split` slots (fairness), and passes repeat until the chunk is
        # full or the lane is drained (occupancy).
        progress = True
        while used < self.slots and progress:
            progress = False
            for item in self.queue:
                if item.lane != lane or used >= self.slots:
                    continue
                take = min(self.split, item.remaining, self.slots - used)
                if take <= 0:
                    continue
                assignments.append(Assignment(item=item, start=item.cursor,
                                              n=take, slot=used))
                item.cursor += take
                used += take
                if item not in served:
                    served.append(item)
                progress = True
        # rotation: finished items leave; served-but-unfinished items go
        # to the back so queued neighbors (any lane) reach the head.
        for item in served:
            self.queue.remove(item)
        for item in served:
            if item.remaining > 0:
                self.queue.append(item)
        return TickPlan(lane=lane, slots=self.slots, used=used,
                        assignments=assignments)
