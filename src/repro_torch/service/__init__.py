"""repro_torch.service — Actuary-as-a-service (the counterpart of
``repro.service``).

A continuous-batching cost-query server over the fused
``repro_torch.dse`` pipeline: concurrent clients submit typed pricing
requests, an async scheduler coalesces them into constant-shape device
ticks, and every response is bit-exact against the equivalent direct
:class:`~repro_torch.dse.evaluate.ChunkedEvaluator` /
``portfolio_search`` call on the same device.  See
:mod:`repro_torch.service.server` for the tick loop.  It runs on the GPU
unless the caller passes ``device="cpu"``.
"""
from .cache import LaneSignature, ResultCache, TraceCache, \
    index_digest, space_fingerprint
from .durability import DurabilityConfig, JournalEntry, RequestJournal, \
    request_from_wire, request_to_wire
from .metrics import DurabilityStats, RequestRecord, ResilienceStats, \
    ServiceMetrics
from .protocol import DEADLINE_EXCEEDED, ErrorInfo, INTERNAL_ERROR, \
    INVALID_REQUEST, \
    McSpec, MCRiskRequest, NUMERICAL_ERROR, PriceRequest, \
    PriceSystemsRequest, QUEUE_FULL, SHUTTING_DOWN, \
    RankRequest, RankResult, Request, RequestLog, Response, SearchRequest, \
    SystemsResult, Timing, WhatIfRequest, WhatIfResult, error_response, \
    validate_request
from .scheduler import Assignment, GenWork, GroupWork, Lane, Scheduler, \
    SpanWork, TickPlan
from .server import PricingService, SearchTask, SearchWarmup, \
    ServiceConfig, ServiceError, SimulatedCrash, serve

__all__ = [
    "DEADLINE_EXCEEDED", "ErrorInfo", "INTERNAL_ERROR", "INVALID_REQUEST",
    "NUMERICAL_ERROR", "QUEUE_FULL", "SHUTTING_DOWN",
    "McSpec", "MCRiskRequest", "PriceRequest", "PriceSystemsRequest",
    "RankRequest", "RankResult", "Request", "RequestLog", "Response",
    "SearchRequest", "SystemsResult", "Timing", "WhatIfRequest",
    "WhatIfResult", "error_response", "validate_request",
    "Lane", "Scheduler", "SpanWork", "GroupWork", "GenWork", "Assignment",
    "TickPlan",
    "LaneSignature", "ResultCache", "TraceCache", "index_digest",
    "space_fingerprint",
    "DurabilityConfig", "JournalEntry", "RequestJournal",
    "request_from_wire", "request_to_wire",
    "DurabilityStats", "RequestRecord", "ResilienceStats", "ServiceMetrics",
    "PricingService", "SearchTask", "SearchWarmup", "ServiceConfig",
    "ServiceError", "SimulatedCrash", "serve",
]
