"""Typed request/response envelopes for the pricing service (the
counterpart of ``repro.service.protocol``, with the same dataclasses,
error codes and validation).

The wire contract of :class:`~repro_torch.service.server.PricingService`,
following the shape of vLLM's ``serving_engine.py`` protocol layer: every
submission is a typed request dataclass; every outcome — including
failures — comes back as a :class:`Response` envelope carrying the
request id, timing, and either a result payload or a typed
:class:`ErrorInfo`.  A request NEVER raises into a sibling: errors are
enveloped per request and the tick loop keeps serving.

Request types (all priced through the fused ``repro_torch.dse`` graphs and
therefore bit-exact against direct :class:`ChunkedEvaluator` /
``portfolio_search`` calls):

* :class:`PriceRequest`    — price a candidate index/object list.
* :class:`RankRequest`     — price + rank a candidate set (or the whole
  space), return the top-k with materialized labels.
* :class:`MCRiskRequest`   — Monte-Carlo risk sweep over candidates.
* :class:`WhatIfRequest`   — packaging/node deltas around a base
  candidate (the Tang & Xie-style "what if we used InFO instead of MCM
  at 5nm?" grid).
* :class:`SearchRequest`   — evolutionary portfolio search, advanced one
  generation step per tick so long searches interleave with point
  queries.
* :class:`PriceSystemsRequest` — price a raw ``spec()`` dict list (no
  DesignSpace needed), coalesced into a fixed padded engine batch.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..dse.evaluate import CandidateResult, EvalArrays
from ..dse.search import RiskConfig, SearchResult
from ..dse.space import Candidate
from ..dse.uncertainty import Uncertainty
from ..resilience.guards import nonfinite_paths

# Typed error codes (the closed set clients may dispatch on).
QUEUE_FULL = "queue_full"            # backpressure: bounded queue rejected
INVALID_REQUEST = "invalid_request"  # failed validation at admission
INTERNAL_ERROR = "internal"          # tick-time failure, isolated per request
DEADLINE_EXCEEDED = "deadline_exceeded"  # deadline_ms elapsed before done
NUMERICAL_ERROR = "numerical_error"  # non-finite cost in this request's rows
SHUTTING_DOWN = "shutting_down"      # drain deadline hit / service stopping


def mint_trace_id() -> str:
    """Mint a request trace id at admission: 16 hex chars, unique per
    process for all practical purposes.  The id is *durable* — it rides
    the journal's wire records and search checkpoints, so the response
    to a crash-replayed request carries the SAME trace_id the original
    admission minted, and one id correlates the whole causal chain:
    admission -> journal -> (crash, replay) -> coalesced ticks ->
    terminal envelope."""
    return os.urandom(8).hex()


@dataclasses.dataclass(frozen=True)
class ErrorInfo:
    """Typed error envelope — returned, never raised across requests."""

    code: str
    message: str


@dataclasses.dataclass(frozen=True)
class Timing:
    """Per-request latency surface (seconds, service-relative)."""

    submit_s: float            # absolute submit timestamp (perf_counter)
    first_result_s: float      # submit -> first coalesced rows on host
    done_s: float              # submit -> response ready


@dataclasses.dataclass(frozen=True)
class McSpec:
    """Monte-Carlo configuration of a risk sweep.

    ``(draws, quantiles)`` are static signature components of the
    Monte Carlo chunk — keep
    them on the service's warmed menu (``ServiceConfig.warm_mc``) so the
    hot path never recompiles; ``seed``/``sigmas`` are traced arguments
    and coalesce freely among requests that share them.
    """

    draws: int = 128
    quantiles: Tuple[float, ...] = (0.5, 0.9)
    seed: int = 0
    sigmas: Uncertainty = dataclasses.field(default_factory=Uncertainty)


@dataclasses.dataclass(frozen=True)
class PriceRequest:
    """Price a candidate list: indices (fast path) or Candidate objects."""

    indices: Optional[Sequence[int]] = None
    candidates: Tuple[Candidate, ...] = ()
    flow: str = "chip-last"
    mc: Optional[McSpec] = None      # attach risk stats to every row
    deadline_ms: Optional[float] = None  # wall budget; see validate_request

    kind = "price"


@dataclasses.dataclass(frozen=True)
class RankRequest:
    """Price + rank a candidate set; ``indices=None`` ranks the whole
    space.  Ties rank by candidate index (deterministic)."""

    indices: Optional[Sequence[int]] = None
    top_k: int = 10
    flow: str = "chip-last"
    mc: Optional[McSpec] = None      # rank on a risk stat instead of cost
    objective: str = "cost"          # "cost" or a risk key (e.g. "q90")
    deadline_ms: Optional[float] = None

    kind = "rank"


@dataclasses.dataclass(frozen=True)
class MCRiskRequest:
    """Monte-Carlo risk sweep: per-candidate quantiles under common
    random numbers (same scenarios for every candidate)."""

    indices: Sequence[int] = ()
    mc: McSpec = dataclasses.field(default_factory=McSpec)
    flow: str = "chip-last"
    deadline_ms: Optional[float] = None

    kind = "mc_risk"


@dataclasses.dataclass(frozen=True)
class WhatIfRequest:
    """Packaging/node what-if grid around ``base``: re-price the same
    architecture under every (process, integration) combination and
    report deltas vs the base.  Empty axes default to the space's menus;
    combinations outside the space are reported in ``skipped``, not
    errored."""

    base: Union[Candidate, int] = 0
    processes: Tuple[str, ...] = ()
    integrations: Tuple[str, ...] = ()
    flow: str = "chip-last"
    deadline_ms: Optional[float] = None

    kind = "what_if"


@dataclasses.dataclass(frozen=True)
class SearchRequest:
    """Evolutionary portfolio search (see ``repro_torch.dse.portfolio_search``
    — same semantics, same determinism in ``seed``), served one
    generation step per tick."""

    seed: int = 0
    population: int = 32
    generations: int = 12
    elite: int = 6
    jump_prob: float = 0.15
    risk: Optional[RiskConfig] = None
    flow: str = "chip-last"
    deadline_ms: Optional[float] = None  # checked between generations too

    kind = "search"


@dataclasses.dataclass(frozen=True)
class PriceSystemsRequest:
    """Price a raw system ``spec()`` dict list (one co-produced
    ``share_nre`` group, like ``SystemBatch.from_specs``); no DesignSpace
    membership required.  The group is priced in one tick (NRE amortizes
    across the group), so it must fit the service's raw-lane budget."""

    specs: Tuple[Dict[str, Any], ...] = ()
    flow: str = "chip-last"
    deadline_ms: Optional[float] = None

    kind = "price_systems"


Request = Union[PriceRequest, RankRequest, MCRiskRequest, WhatIfRequest,
                SearchRequest, PriceSystemsRequest]


# ---------------------------------------------------------------------------
# Result payloads
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RankResult:
    """Top-k of a ranked candidate set."""

    objective: str
    order: np.ndarray                  # (n,) candidate indices, best first
    values: np.ndarray                 # (n,) objective values, sorted
    top: List[CandidateResult]         # materialized top-k (labels etc.)


@dataclasses.dataclass
class WhatIfResult:
    """Per-(process, integration) re-pricing of the base architecture."""

    base_label: str
    base_cost: float
    rows: List[Dict]                   # label/process/integration/cost/delta
    skipped: List[Dict]                # combos outside the space + reason


@dataclasses.dataclass
class SystemsResult:
    """Per-system engine totals for a raw spec-list group."""

    rows: List[Dict]                   # name / re / nre / total / quantity


@dataclasses.dataclass
class Response:
    """The one answer envelope: ``ok`` + result, or a typed error."""

    request_id: int
    kind: str
    ok: bool
    result: Optional[Union[EvalArrays, RankResult, WhatIfResult,
                           SearchResult, SystemsResult]] = None
    error: Optional[ErrorInfo] = None
    timing: Optional[Timing] = None
    cached: bool = False               # served from the result cache
    # Degraded-mode provenance: True when any row of this response was
    # priced through the legacy host-packing fallback instead of the
    # fused path.  For row-sweep kinds ("price"/"mc_risk"),
    # degraded_rows is the (K,) bool per-row mask; degraded values are
    # float32 casts of the legacy oracle's float64s (slow-but-correct).
    degraded: bool = False
    degraded_rows: Optional[np.ndarray] = None
    # Replay provenance: True when this response answers a request that
    # was re-admitted from the durable journal after a crash/restart.
    # ``replayed_from`` is the ORIGINAL admission uid (stable across
    # replay chains), so clients can correlate with pre-crash ids.
    replayed: bool = False
    replayed_from: Optional[int] = None
    # Request-scoped trace id (see mint_trace_id): set on EVERY envelope
    # the service emits — ok, cached, degraded, replayed, and typed
    # errors alike — and stable across crash replay.
    trace_id: str = ""
    # The request's finalized serving-cost bill (obs.ledger.Bill.as_dict):
    # pro-rated device ms, rows priced, padded waste, cache/degraded/
    # replay provenance.  None only when the service ran without a ledger.
    bill: Optional[Dict] = None

    @property
    def latency_s(self) -> float:
        return self.timing.done_s if self.timing else 0.0


def validate_request(req: Request) -> Optional[str]:
    """Admission-time numerical validation; returns a problem string (the
    caller owes an ``invalid_request`` envelope) or None.

    Walks every numeric field of the request — including nested specs,
    McSpec sigmas, and candidate objects — and rejects NaN/Inf before
    they can reach a fused chunk and contaminate coalesced siblings.
    Also rejects non-positive ``deadline_ms`` (a deadline that can never
    be met is a client bug, not a ``deadline_exceeded`` outcome).
    """
    problems = nonfinite_paths(req, path=getattr(req, "kind", "request"))
    if problems:
        return "non-finite numeric field(s): " + "; ".join(problems)
    deadline = getattr(req, "deadline_ms", None)
    if deadline is not None and deadline <= 0:
        return f"deadline_ms must be positive, got {deadline}"
    return None


def error_response(request_id: int, kind: str, code: str, message: str,
                   t_submit: float = 0.0, trace_id: str = "") -> Response:
    now = time.perf_counter()
    dt = max(0.0, now - t_submit) if t_submit else 0.0
    return Response(request_id=request_id, kind=kind, ok=False,
                    error=ErrorInfo(code=code, message=message),
                    timing=Timing(submit_s=t_submit, first_result_s=dt,
                                  done_s=dt),
                    trace_id=trace_id)


# ---------------------------------------------------------------------------
# Request logging (vLLM serving_engine-style)
# ---------------------------------------------------------------------------


class RequestLog:
    """Structured per-request event log.

    Mirrors vLLM's ``RequestLogger``: every admission/completion/error is
    one event with the request id and a compact summary — queryable in
    tests via :meth:`records` and mirrored to the ``repro_torch.service``
    :mod:`logging` channel (DEBUG) for operators."""

    def __init__(self, keep: int = 1024,
                 logger: Optional[logging.Logger] = None):
        self.keep = int(keep)
        self.logger = logger or logging.getLogger("repro_torch.service")
        self._records: List[Dict] = []

    def event(self, request_id: int, event: str, **fields):
        rec = {"t": time.perf_counter(), "request_id": int(request_id),
               "event": event, **fields}
        self._records.append(rec)
        if len(self._records) > self.keep:
            del self._records[:len(self._records) - self.keep]
        self.logger.debug("req %d %s %s", request_id, event, fields)

    def records(self, request_id: Optional[int] = None,
                event: Optional[str] = None) -> List[Dict]:
        return [r for r in self._records
                if (request_id is None or r["request_id"] == request_id)
                and (event is None or r["event"] == event)]
