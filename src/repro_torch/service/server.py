"""Actuary-as-a-service: the continuous-batching cost-query server (the
counterpart of ``repro.service.server``).

The same slot/pad idiom as :mod:`repro_torch.serving.engine` (vLLM-style
continuous batching), but the "decode step" is the fused DSE chunk:
concurrent clients submit typed pricing requests
(:mod:`repro_torch.service.protocol`), an async scheduler
(:mod:`repro_torch.service.scheduler`) coalesces heterogeneous pending
work into the constant ``chunk_shape`` signatures of
:class:`~repro_torch.dse.evaluate.ChunkedEvaluator` /
``portfolio_search``, dispatches ONE device tick, and streams
per-request results back with exactly one device-to-host copy per tick
(:func:`repro_torch.obs.torchhooks.to_host` of one packed tensor).
Everything a tick does before that copy queues work on the device
without a host sync: host inputs go up through pinned memory without
blocking (:func:`repro_torch.upload`).

Because ticks call the very same module-level probes the direct APIs
use (``_CHUNK_PROBE`` / ``_CHUNK_MC_PROBE`` / ``_GEN_STEP_PROBE`` /
``_TOTAL_PROBE``), and because every per-candidate value in those graphs
depends only on its own row (padding is cost-neutral by construction,
and no reduction runs across candidates), a coalesced response is
**bit-exact** against the equivalent single-request
``ChunkedEvaluator.evaluate_indices`` / ``portfolio_search`` call at the
same chunk shape, on the same device.

Lifecycle::

    svc = PricingService(space, ServiceConfig(chunk=128))   # the GPU
    await svc.start()            # runs every configured lane once
    resp = await svc.submit(PriceRequest(indices=[3, 17, 912]))
    resp.result.portfolio_cost   # EvalArrays, bit-exact vs direct call
    await svc.stop()

or synchronously: ``responses, svc = serve(space, requests, config)``.
Both run on the GPU unless the caller passes ``device="cpu"``, and raise
without a GPU otherwise.
"""
from __future__ import annotations

import asyncio
import dataclasses
import shutil
import signal
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import random as prng
from .. import resolve_device, upload
from ..checkpoint.store import CheckpointManager
from ..core.batch import SystemBatch, pad_batch
from ..core.engine import _TOTAL_PROBE
from ..core.system import System, spec
from ..dse.evaluate import _CHUNK_MC_PROBE, _CHUNK_PROBE, \
    ChunkedEvaluator, EvalArrays, pack_rows, unpack_rows
from ..dse.search import _GEN_STEP_PROBE, SearchResult, SearchState, \
    _default_mc_key, _front, _rank, _read_generation
from ..dse.space import ArchChoice, Candidate, DesignSpace
from ..obs import torchhooks
from ..obs.flight import FlightRecorder
from ..obs.ledger import Bill, Ledger
from ..obs.slo import SLObjective, SLOTracker
from ..obs.trace import TRACER as _TRACER
from ..resilience import CircuitBreaker, FaultInjector, InjectedFault, \
    Watchdog
from .cache import LaneSignature, ResultCache, TraceCache, space_fingerprint
from .durability import DurabilityConfig, RequestJournal, request_to_wire
from .metrics import DurabilityStats, RequestRecord, ResilienceStats, \
    ServiceMetrics
from .protocol import DEADLINE_EXCEEDED, INTERNAL_ERROR, INVALID_REQUEST, \
    NUMERICAL_ERROR, QUEUE_FULL, SHUTTING_DOWN, McSpec, PriceRequest, \
    PriceSystemsRequest, Request, RequestLog, Response, SearchRequest, \
    SystemsResult, Timing, WhatIfRequest, WhatIfResult, RankResult, \
    error_response, mint_trace_id, validate_request
from .scheduler import GenWork, GroupWork, Lane, Scheduler, SpanWork, \
    TickPlan


class ServiceError(Exception):
    """Admission-time rejection; becomes a typed error envelope."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code


class SimulatedCrash(RuntimeError):
    """Raised by the injected ``crash`` fault kind: the moral equivalent
    of SIGKILL at a tick boundary — in-flight futures get typed
    ``shutting_down`` envelopes so test clients unblock, but NO journal
    terminals are written, so a subsequent :meth:`PricingService.start`
    must replay the journal exactly as after a real process death."""


@dataclasses.dataclass(frozen=True)
class SearchWarmup:
    """One generation-step signature to warm at startup."""

    population: int = 32
    elite: int = 6
    jump_prob: float = 0.15
    n_draws: int = 0          # 0 = nominal objective
    quantile: float = 0.5


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Serving shape + warmup menu.  ``chunk`` and the warm lists are
    lane signature components: requests outside the warmed menu still
    work, but run their lane's first call at admission time (never inside
    a tick)."""

    chunk: int = 64                    # candidate slots per device tick
    split: Optional[int] = None        # max slots one request takes per pass
    flows: Tuple[str, ...] = ("chip-last",)
    max_pending: int = 1_000_000       # queued-row budget (backpressure)
    raw_slots: int = 16                # system slots of the raw spec lane
    raw_max_chips: Optional[int] = None
    result_cache_entries: int = 256
    result_cache_max_rows: int = 65536
    warm_mc: Tuple[Tuple[int, Tuple[float, ...]], ...] = ((128, (0.5, 0.9)),)
    warm_search: Tuple[SearchWarmup, ...] = ()
    log_keep: int = 1024
    flight_capacity: int = 2048        # flight-recorder ring (always on)
    # -- failure handling (see README "Failure handling") ------------------
    tick_retries: int = 1              # fused re-dispatch attempts per tick
    retry_backoff_s: float = 0.005     # linear backoff between attempts
    fallback: bool = True              # degrade to the legacy host path
    breaker_threshold: int = 1         # consecutive failures that open it
    breaker_cooldown_s: float = 2.0    # open -> half_open re-probe delay
    watchdog_timeout_s: Optional[float] = None   # None = no watchdog
    # -- durability / lifecycle (see README "Durability & restart") --------
    durability: Optional[DurabilityConfig] = None  # None = no journal
    drain_timeout_s: Optional[float] = None  # stop(): None = unbounded drain
    sigterm_drain: bool = False        # SIGTERM -> bounded-drain stop()
    # -- SLOs (see README "Observability") ---------------------------------
    # Declarative latency/availability objectives per request kind; empty
    # tuple = no SLO tracking (default, zero overhead).  A burn-rate
    # excursion past an objective's alert threshold records a flight
    # event and auto-dumps context when REPRO_FLIGHT_DIR is set.
    slos: Tuple[SLObjective, ...] = ()


@dataclasses.dataclass(eq=False)
class _Active:
    """Server-side state of one in-flight request."""

    uid: int
    kind: str
    request: Request
    rec: RequestRecord
    future: asyncio.Future
    cost: int = 0                      # admitted row budget (released at end)
    n_rows: int = 0
    rows_done: int = 0
    idx: Optional[np.ndarray] = None
    accum: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    risk_keys: Tuple[str, ...] = ()
    payload_fn: Optional[Callable] = None    # EvalArrays -> result payload
    cache_key: Optional[Tuple] = None
    on_partial: Optional[Callable] = None
    task: Optional["SearchTask"] = None
    failed: bool = False
    deadline_t: Optional[float] = None       # absolute perf_counter deadline
    degraded: bool = False                   # any row via legacy fallback
    degraded_rows: Optional[np.ndarray] = None   # (n,) provenance mask
    # Replay provenance: set when this admission re-plays a journaled
    # request; ``origin`` is the stable id across replay chains (= uid
    # for fresh admissions) and keys the search checkpoint directory.
    replayed_from: Optional[int] = None
    origin: int = 0
    # Request-scoped trace id (minted at admission, durable across
    # crash replay) and the request's open serving-cost bill.
    trace_id: str = ""
    bill: Optional[Bill] = None


def _risk_keys(quantiles: Tuple[float, ...]) -> Tuple[str, ...]:
    return ("mean", "std") + tuple(f"q{int(round(q * 100))}"
                                   for q in quantiles)


def _seed_key(seed: int, device) -> torch.Tensor:
    """``prng.PRNGKey(seed)`` on ``device``, carried up through pinned
    memory without blocking the host."""
    return upload(prng.PRNGKey(seed, device="cpu"), device)


class SearchTask:
    """Device-side state of one evolutionary search, advanced one
    generation step per tick.  The loop state is a
    :class:`~repro_torch.dse.search.SearchState` — the same carrier
    ``portfolio_search`` checkpoints — so the key schedule, generation
    step, history, final ranking, AND checkpoint/restore semantics
    replicate the direct call exactly: a served (or resumed) search is
    bit-exact against ``portfolio_search``."""

    def __init__(self, svc: "PricingService", active: _Active,
                 sr: SearchRequest):
        self.svc = svc
        self.active = active
        self.sr = sr
        self.obj = "cost"
        self.n_draws, self.quantile = 0, 0.5
        if sr.risk is not None:
            self.obj = sr.risk.objective_key
            self.n_draws = int(sr.risk.n_draws)
            self.quantile = float(sr.risk.quantile)
        self.state = SearchState.init(_seed_key(sr.seed, svc.device),
                                      sr.population, svc.space.size(),
                                      sr.risk)
        # the trace id rides the checkpoint manifest, so a resumed
        # search continues the SAME request trace
        self.state.trace_id = active.trace_id

    @property
    def gen(self) -> int:
        return self.state.gen

    @property
    def mc_key(self):
        return self.state.mc_key

    @property
    def mc_key_words(self) -> Tuple[int, int]:
        """The Monte Carlo key's words, derived on the host as
        ``SearchState.init`` derives them on the device (a pure function
        of the seed, a restored state's included), so the ranking sweep's
        lane needs no read of the device."""
        key = prng.PRNGKey(self.sr.seed, device="cpu")
        if self.sr.risk is not None:
            key = _default_mc_key(key)
        return tuple(int(w) for w in key.tolist())

    def device_call(self):
        """Dispatch one generation; returns the arrays to fetch (the
        next population stays on device)."""
        st = self.state
        st.k_loop, k_gen = prng.split(st.k_loop).unbind(0)
        pop_out, pop_next, gen_idx, gen_obj = _GEN_STEP_PROBE(
            self.svc.tables, k_gen, st.pop, self.svc.qty,
            st.mc_key, st.sig, meta=self.svc.enc.meta,
            flow=self.sr.flow, population=self.sr.population,
            elite=self.sr.elite, jump_prob=float(self.sr.jump_prob),
            n_draws=self.n_draws, quantile=self.quantile)
        st.pop = pop_next
        return (pop_out, gen_idx, gen_obj)

    def consume(self, host) -> bool:
        """Fold one generation's host results in; True when the
        generation budget is spent (ranking sweep comes next)."""
        self.state.consume(
            host, lambda i: self.svc.space.candidate_at(i).label())
        return self.state.gen >= self.sr.generations

    def uniq_indices(self) -> np.ndarray:
        return np.asarray(sorted(self.state.seen), np.int64)

    def finalize(self, arrays: EvalArrays) -> SearchResult:
        results = self.svc.ev.results_from_arrays(arrays)
        ranked = _rank(results, self.obj)
        return SearchResult(best=ranked[0], ranked=ranked,
                            pareto=_front(ranked, self.obj),
                            history=self.state.history,
                            n_evaluated=len(results),
                            objective_key=self.obj)


class PricingService:
    """The continuous-batching pricing server for one
    :class:`~repro_torch.dse.space.DesignSpace`, on ``device`` (the GPU
    unless the caller names another)."""

    def __init__(self, space: DesignSpace,
                 config: Optional[ServiceConfig] = None,
                 log: Optional[RequestLog] = None, *, device=None):
        self.space = space
        self.cfg = config or ServiceConfig()
        if not self.cfg.flows:
            raise ValueError("service needs at least one flow")
        self.device = resolve_device(device)
        self.enc = space.encoder()
        self.tables = self.enc.tables_on(self.device)
        self.qty = torch.tensor([sk.quantity for sk in space.skus],
                                dtype=torch.float32, device=self.device)
        self.n_skus = len(space.skus)
        # direct-API twin: shares the module-level probes (and therefore
        # the warm signatures) with every tick; also the host-side
        # results_from_arrays helper.
        self.ev = ChunkedEvaluator(space, candidates_per_chunk=self.cfg.chunk,
                                   flow=self.cfg.flows[0],
                                   device=self.device)
        self.fingerprint = space_fingerprint(space)
        self.sched = Scheduler(slots=self.cfg.chunk, split=self.cfg.split,
                               raw_slots=self.cfg.raw_slots,
                               max_pending=self.cfg.max_pending)
        self.metrics = ServiceMetrics()
        self.flight = FlightRecorder(capacity=self.cfg.flight_capacity)
        self.log = log or RequestLog(keep=self.cfg.log_keep)
        self.traces = TraceCache()
        self.results = ResultCache(self.cfg.result_cache_entries,
                                   self.cfg.result_cache_max_rows)
        self.raw_max_chips = (self.cfg.raw_max_chips
                              or max(space.max_chips(), 4))
        r, c = self.cfg.raw_slots, self.raw_max_chips
        self.raw_pad = dict(n_systems=r, max_chips=c,
                            chip_entities=r * c + 1, pkg_entities=r + 1,
                            mod_entities=2 * r * c + 1,
                            mod_instances=2 * r * c,
                            d2d_entities=r * c + 1, d2d_instances=r * c)
        self._lane_args: Dict[Lane, Tuple] = {}
        self._active: Dict[int, _Active] = {}
        self._uid = 0
        self._task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._running = False
        self.warmed = False
        # -- failure handling (repro_torch.resilience) ------------------
        self.faults = FaultInjector.from_env()
        self.res = ResilienceStats()
        self.breaker = CircuitBreaker(
            threshold=self.cfg.breaker_threshold,
            cooldown_s=self.cfg.breaker_cooldown_s,
            on_event=self._on_breaker_event)
        self.watchdog = (Watchdog(self.cfg.watchdog_timeout_s,
                                  self._on_stall)
                         if self.cfg.watchdog_timeout_s else None)
        self._deadline_count = 0       # admitted requests with deadlines
        self._fb_evs: Dict[str, ChunkedEvaluator] = {}   # per-flow legacy
        # -- serving-cost ledger + SLO tracking (repro_torch.obs) --------
        self.ledger = Ledger()
        self.slo: Optional[SLOTracker] = (
            SLOTracker(self.cfg.slos, on_burn=self._on_slo_burn)
            if self.cfg.slos else None)
        # completions found during a tick are deferred until after the
        # tick's wall is measured and billed, so a finishing request's
        # bill includes its final tick's share (see _tick)
        self._tick_done: List[Callable] = []
        self._raw_parts: Optional[List[GroupWork]] = None
        # -- durability (repro_torch.service.durability) ----------------
        self.dur = DurabilityStats()
        self.dcfg = self.cfg.durability
        self.journal: Optional[RequestJournal] = None
        self._ckpt_mgrs: Dict[int, CheckpointManager] = {}
        self._accepting = True         # False while draining/crashed
        self._sigterm_installed = False
        self.replayed_tasks: List[asyncio.Task] = []

    # ------------------------------------------------------------------
    # Failure handling (repro_torch.resilience glue)
    # ------------------------------------------------------------------

    def _fire(self, kind: str):
        """Check the fault injector at one call site.  Costs a single
        truthiness check when ``REPRO_FAULTS`` is unset."""
        if not self.faults:
            return None
        rule = self.faults.fire(kind)
        if rule is not None:
            self.res.bump("faults_injected")
            self.flight.record("fault", kind=kind)
        return rule

    def _on_breaker_event(self, event: str):
        self.res.bump(f"breaker_{event}s")
        self.log.event(-1, f"breaker_{event}")
        self.flight.record("breaker", transition=event,
                           state=self.breaker.state)

    def _on_slo_burn(self, kind: str, dimension: str, burn: float,
                     trace_id: str):
        """An error-budget burn rate crossed its alert threshold (latched
        once per excursion by the tracker): record the event with the
        offending trace id and auto-dump the flight recorder so the
        context around the burn is preserved."""
        self.log.event(-1, "slo_burn", kind=kind, dimension=dimension,
                       burn=round(burn, 3), trace_id=trace_id)
        self.flight.record("slo_burn", kind=kind, dimension=dimension,
                           burn=burn, trace_id=trace_id)
        if FlightRecorder.auto_dump_dir() is not None:
            try:
                self.dump_flight_recorder()
            except OSError:
                pass                  # never let a dump break serving

    def _on_stall(self, elapsed: float):
        """Watchdog callback — runs on the watchdog thread, so: evidence
        only (counter bumps are GIL-atomic, the flight ring is append-
        only).  The stuck tick itself cannot be preempted; recovery is
        the loop guard in :meth:`_run` plus :meth:`_ensure_loop`."""
        self.res.bump("watchdog_trips")
        self.flight.record("watchdog_trip", busy_s=elapsed)
        path = None
        if FlightRecorder.auto_dump_dir() is not None:
            try:
                path = self.dump_flight_recorder()
                self.res.bump("watchdog_dumps")
            except OSError:
                path = None
        self.log.event(-1, "watchdog_trip", busy_s=elapsed,
                       dump=str(path) if path else None)

    def _ensure_loop(self):
        """Relaunch the tick-loop task if it died (it should not — the
        loop guard contains per-tick exceptions — but a dead loop must
        never strand admitted work)."""
        if self._running and self._task is not None and self._task.done():
            self.res.bump("loop_restarts")
            self.log.event(-1, "loop_restart")
            self.flight.record("loop_restart")
            self._task = asyncio.get_running_loop().create_task(self._run())

    def _close_bill(self, req: _Active, ok: bool, status: str,
                    cache_hit: bool = False,
                    observe_slo: bool = True) -> Optional[Dict]:
        """Finalize a request's cost bill and feed the SLO tracker —
        the one terminal-accounting path every outcome goes through.
        Returns the bill as a JSON-ready dict for the response envelope.
        """
        degraded = 0
        if isinstance(req.degraded_rows, np.ndarray):
            degraded = int(req.degraded_rows.sum())
        if req.bill is not None:
            self.ledger.close(req.bill, status=status, cache_hit=cache_hit,
                              degraded_rows=degraded,
                              latency_s=req.rec.latency_s)
        if self.slo is not None and observe_slo:
            self.slo.observe(req.kind, req.rec.latency_s, ok,
                             trace_id=req.trace_id)
        return req.bill.as_dict() if req.bill is not None else None

    def _cancel(self, req: _Active):
        """Client abandoned an admitted request (awaiter cancelled):
        drop its queued work, release its row budget, count it.  No
        envelope — there is nobody left to receive one."""
        if req.failed or req.uid not in self._active:
            return
        req.failed = True
        if req.deadline_t is not None:
            self._deadline_count -= 1
        self.sched.drop_owned_by(req)
        self.sched.release(req.cost)
        self.metrics.finish_request(req.rec, ok=False)
        # a cancellation is the client's doing, not the service's: close
        # the bill but keep it out of the availability error budget
        self._close_bill(req, ok=False, status="cancelled",
                         observe_slo=False)
        self._active.pop(req.uid, None)
        if self.journal is not None:
            self.journal.done(req.uid, "cancelled")
        self.res.bump("cancelled")
        self.log.event(req.uid, "cancelled")
        self.flight.record("request_cancelled", uid=req.uid, kind=req.kind,
                           trace_id=req.trace_id)

    def _fallback_evaluator(self, flow: str) -> ChunkedEvaluator:
        """The legacy host-packing evaluator degraded ticks price
        through (the parity oracle: float32 casts of its float64s)."""
        if flow == self.ev.flow:
            return self.ev
        ev = self._fb_evs.get(flow)
        if ev is None:
            ev = ChunkedEvaluator(self.space,
                                  candidates_per_chunk=self.cfg.chunk,
                                  flow=flow, fused=False, device=self.device)
            self._fb_evs[flow] = ev
        return ev

    # ------------------------------------------------------------------
    # Warmup: run every configured lane signature once before serving
    # ------------------------------------------------------------------

    def warmup(self):
        """Run every configured lane signature once, so no tick is ever
        the first call of one: that first call takes the allocator's
        first blocks, the libraries' handles and the pinned staging
        buffers.  Idempotent; called by :meth:`start`."""
        for flow in self.cfg.flows:
            self._ensure_chunk(flow)
            for draws, quantiles in self.cfg.warm_mc:
                self._ensure_mc(flow, int(draws), tuple(quantiles))
            if self.cfg.raw_slots > 0:
                self._ensure_raw(flow)
            for w in self.cfg.warm_search:
                self._ensure_gen(flow, w)
        self.warmed = True

    def _ensure_chunk(self, flow: str, trace_id: str = ""):
        sig = LaneSignature("chunk", flow)
        self.traces.ensure(sig, lambda: torchhooks.to_host(pack_rows(
            _CHUNK_PROBE(self.tables, self._idx0(), self.qty,
                         meta=self.enc.meta, flow=flow))[0]),
            trace_id=trace_id)
        if self.cfg.fallback:
            # warm the degraded path's engine signature too, so a tick
            # that falls back never makes a first call mid-tick (the
            # fallback always prices a full, padded chunk — one constant
            # signature).
            idx0 = np.zeros((self.cfg.chunk,), np.int64)
            self.traces.ensure(
                LaneSignature("fallback", flow),
                lambda: self._fallback_evaluator(flow)
                .evaluate_indices_legacy(idx0))

    def _ensure_mc(self, flow: str, draws: int, quantiles: Tuple[float, ...],
                   trace_id: str = ""):
        sig = LaneSignature("mc", flow, (draws, quantiles))
        self.traces.ensure(sig, lambda: torchhooks.to_host(pack_rows(
            _CHUNK_MC_PROBE(self.tables, self._idx0(), self.qty,
                            _seed_key(0, self.device),
                            torch.zeros((4,), dtype=torch.float32,
                                        device=self.device),
                            meta=self.enc.meta, flow=flow, n_draws=draws,
                            quantiles=quantiles))[0]),
            trace_id=trace_id)
        if self.cfg.fallback:
            # sigmas are tensor arguments (not signature components) —
            # warming with the defaults covers every sigma set at this
            # shape.
            idx0 = np.zeros((self.cfg.chunk,), np.int64)
            self.traces.ensure(
                LaneSignature("fallback_mc", flow, (draws, quantiles)),
                lambda: self._fallback_evaluator(flow)
                .evaluate_indices_legacy(
                    idx0, mc_key=_seed_key(0, self.device), mc_draws=draws,
                    mc_quantiles=quantiles))

    def _ensure_gen(self, flow: str, w: SearchWarmup, trace_id: str = ""):
        sig = LaneSignature("gen", flow, (w.population, w.elite,
                                          float(w.jump_prob), w.n_draws,
                                          float(w.quantile)))

        def run_gen():
            key0 = _seed_key(0, self.device)
            # the task's own key schedule (randint/split/fold_in) runs on
            # the device too — run it once here, as a fresh SearchTask will
            k_init, _ = prng.split(key0).unbind(0)
            _default_mc_key(key0)
            pop0 = prng.randint(k_init, (w.population,), 0,
                                self.space.size())
            out = _GEN_STEP_PROBE(
                self.tables, key0, pop0, self.qty, key0,
                torch.zeros((4,), dtype=torch.float32, device=self.device),
                meta=self.enc.meta, flow=flow, population=w.population,
                elite=w.elite, jump_prob=float(w.jump_prob),
                n_draws=w.n_draws, quantile=float(w.quantile))
            _read_generation(out[0], out[2], out[3])

        self.traces.ensure(sig, run_gen, trace_id=trace_id)

    def _ensure_raw(self, flow: str, trace_id: str = ""):
        sig = LaneSignature("raw", flow)

        def run_raw():
            s = spec({"kind": "soc", "name": "__warm", "area": 100.0,
                      "process": self.space.processes[0], "quantity": 1.0})
            self._price_raw(self._pack_raw([s], [0]), flow)

        self.traces.ensure(sig, run_raw, trace_id=trace_id)

    def _idx0(self) -> torch.Tensor:
        """A zero chunk of indices, uploaded as a tick uploads one."""
        return upload(np.zeros((self.cfg.chunk,), np.int32), self.device)

    def _pack_raw(self, systems: List[System],
                  gids: List[int]) -> SystemBatch:
        """A raw-lane group packed on the host (``share_nre`` groups
        ``gids``)."""
        return SystemBatch.from_systems(systems, share_nre=gids,
                                        max_chips=self.raw_max_chips,
                                        device="cpu")

    def _price_raw(self, batch: SystemBatch, flow: str):
        """Price one host-packed raw-lane batch: pad it on the host,
        upload every leaf through pinned memory without blocking, run the
        probed engine total and copy ``(total, re, nre)`` back in one
        copy."""
        padded = pad_batch(batch, **self.raw_pad)
        padded = padded.replace(**{
            f: upload(getattr(padded, f), self.device)
            for f in SystemBatch._LEAVES})
        tc = _TOTAL_PROBE(padded, flow)
        return torchhooks.to_host(torch.stack([tc.total, tc.re.total,
                                                tc.nre.total]))

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    async def start(self):
        if self._task is not None:
            return
        if not self.warmed:
            self.warmup()
        if self.watchdog is not None:
            self.watchdog.start()
        self._wake = asyncio.Event()
        self._running = True
        self._accepting = True
        if self.dcfg is not None and self.journal is None:
            self.journal = RequestJournal(
                self.dcfg.journal_dir,
                fsync_every=self.dcfg.fsync_every,
                segment_max_records=self.dcfg.segment_max_records,
                fingerprint=self.fingerprint, stats_hook=self.dur.bump)
            # uid continuity: new admissions must never collide with
            # uids still open in the journal from a previous process.
            self._uid = max(self._uid, self.journal.max_uid)
        if self.cfg.sigterm_drain:
            try:
                asyncio.get_running_loop().add_signal_handler(
                    signal.SIGTERM, self._on_sigterm)
                self._sigterm_installed = True
            except (NotImplementedError, RuntimeError, ValueError):
                self._sigterm_installed = False
        self._task = asyncio.get_running_loop().create_task(self._run())
        if self.journal is not None:
            self._replay_journal()

    def _on_sigterm(self):
        """SIGTERM = graceful shutdown request: bounded drain with the
        configured ``drain_timeout_s`` (in-flight searches checkpoint at
        the deadline; unfinished work gets typed ``shutting_down``)."""
        self.log.event(-1, "sigterm")
        self.flight.record("sigterm")
        asyncio.get_running_loop().create_task(self.stop())

    def _replay_journal(self):
        """Re-admit every journaled request without a terminal record.
        Each replay admits under a NEW uid (with ``origin`` preserved)
        *before* the old uid's ``replayed`` terminal is written, so a
        crash mid-replay can only duplicate work, never lose it."""
        loop = asyncio.get_running_loop()
        for e in self.journal.replay():
            self.dur.bump("journal_replayed")
            self.log.event(e.uid, "replay", origin=e.origin,
                           kind=e.request.kind)
            self.flight.record("request_replayed", uid=e.uid,
                               origin=e.origin, kind=e.request.kind)
            self.replayed_tasks.append(loop.create_task(
                self.submit(e.request, replayed_from=e.origin,
                            _replaces=e.uid,
                            _trace_id=(e.trace_id or None))))

    async def drain_replayed(self) -> List[Response]:
        """Await every journal-replayed request's response (envelopes,
        never exceptions)."""
        if not self.replayed_tasks:
            return []
        out = await asyncio.gather(*self.replayed_tasks)
        return list(out)

    async def stop(self, drain_timeout_s: Optional[float] = None):
        """Drain remaining work, then stop the tick loop.

        ``drain_timeout_s`` (argument, falling back to
        ``ServiceConfig.drain_timeout_s``) bounds the drain: admission
        stops immediately, in-flight work gets the deadline to finish,
        and at the deadline unfinished searches are checkpointed and
        every unfinished request is failed with a typed
        ``shutting_down`` envelope.  ``None`` (the default) preserves
        the original unbounded drain."""
        timeout = (drain_timeout_s if drain_timeout_s is not None
                   else self.cfg.drain_timeout_s)
        self._accepting = False
        self._running = False
        if self._wake is not None:
            self._wake.set()
        if self._task is not None:
            if timeout is None:
                await self._task
            else:
                self.dur.bump("drain_calls")
                try:
                    await asyncio.wait_for(asyncio.shield(self._task),
                                           timeout)
                except asyncio.TimeoutError:
                    self.dur.bump("drain_timeouts")
                    self._drain_abort()
                    await self._task
            self._task = None
        if self._sigterm_installed:
            try:
                asyncio.get_running_loop().remove_signal_handler(
                    signal.SIGTERM)
            except (NotImplementedError, RuntimeError, ValueError):
                pass
            self._sigterm_installed = False
        if self.journal is not None:
            self.journal.close()
            self.journal = None
        if self.watchdog is not None:
            self.watchdog.stop()

    def _drain_abort(self):
        """The drain deadline passed: checkpoint unfinished searches,
        give every unfinished request a typed ``shutting_down``
        envelope (journaled as terminal — the client was answered, so
        the work will NOT replay), drop the queue, dump the flight
        recorder when ``REPRO_FLIGHT_DIR`` is set."""
        for req in list(self._active.values()):
            if req.failed:
                continue
            if req.kind == "search" and req.task is not None \
                    and self.dcfg is not None:
                try:
                    req.task.state.save(self._ckpt_manager(req.origin))
                    self.dur.bump("checkpoints_written")
                    self.dur.bump("drain_checkpointed")
                except OSError:
                    pass
            self.dur.bump("drain_rejected")
            self._fail(req, SHUTTING_DOWN,
                       f"drain deadline passed with "
                       f"{req.rows_done}/{req.n_rows} rows done")
        self.sched.clear()
        self.flight.record("drain_abort")
        if FlightRecorder.auto_dump_dir() is not None:
            try:
                self.dump_flight_recorder()
            except OSError:
                pass

    def _ckpt_manager(self, origin: int) -> CheckpointManager:
        m = self._ckpt_mgrs.get(origin)
        if m is None:
            m = CheckpointManager(self.dcfg.checkpoint_dir(origin),
                                  keep=self.dcfg.checkpoint_keep)
            self._ckpt_mgrs[origin] = m
        return m

    def _drop_checkpoints(self, origin: int):
        """A search finished ok: its checkpoint tree is dead weight."""
        if self.dcfg is None:
            return
        self._ckpt_mgrs.pop(origin, None)
        d = self.dcfg.checkpoint_dir(origin)
        if d.exists():
            shutil.rmtree(d, ignore_errors=True)
            self.dur.bump("checkpoints_removed")

    def _hard_crash(self):
        """Enact an injected ``crash`` fault: SIGKILL semantics at a
        tick boundary.  In-flight futures resolve with typed
        ``shutting_down`` envelopes (in-process test clients unblock),
        but — deliberately — NO journal terminals are written and the
        journal file handle stays untouched: open admits stay open on
        disk, exactly as after a real process death, and the next
        :meth:`start` replays them."""
        self.dur.bump("crashes")
        self.log.event(-1, "crash")
        self.flight.record("crash", active=len(self._active))
        self._running = False
        self._accepting = False
        for req in list(self._active.values()):
            req.failed = True
            self.metrics.finish_request(req.rec, ok=False)
            bill_dict = self._close_bill(req, ok=False,
                                         status=SHUTTING_DOWN,
                                         observe_slo=False)
            if not req.future.done():
                resp = error_response(
                    req.uid, req.kind, SHUTTING_DOWN,
                    "simulated crash (injected fault)", req.rec.t_submit,
                    trace_id=req.trace_id)
                resp.replayed = req.replayed_from is not None
                resp.replayed_from = req.replayed_from
                resp.bill = bill_dict
                req.future.set_result(resp)
        self._active.clear()
        self._deadline_count = 0
        self.sched.clear()

    async def _run(self):
        while True:
            if not self.sched.has_work():
                if not self._running:
                    break
                self._wake.clear()
                if not self.sched.has_work():        # re-check after clear
                    await self._wake.wait()
                continue
            try:
                self._tick()
            except Exception as e:  # noqa: BLE001 - the loop must survive
                # _tick already fails the tick's owners per request; an
                # exception reaching here is a bug in the failure path
                # itself.  Contain it: count, record, keep serving.
                self.res.bump("loop_errors")
                self.log.event(-1, "loop_error",
                               error=f"{type(e).__name__}: {e}")
                self.flight.record("loop_error",
                                   error=f"{type(e).__name__}: {e}")
            await asyncio.sleep(0)   # let clients submit between ticks

    # ------------------------------------------------------------------
    # Submission
    # ------------------------------------------------------------------

    def _journal_replaced(self, replaces: Optional[int], status: str):
        """A replayed request reached a terminal outcome at admission
        time (cache hit / typed rejection): close out the journaled uid
        it replaces so it does not replay again."""
        if replaces is not None and self.journal is not None:
            self.journal.done(replaces, status)

    def _reject(self, uid: int, request: Request, t_submit: float,
                trace_id: str, code: str, message: str,
                replayed_from: Optional[int] = None,
                rec=None, bill: Optional[Bill] = None) -> Response:
        """Admission-time typed rejection: every rejection still gets a
        trace_id, a closed ledger bill and an SLO availability sample —
        rejected work is spent error budget, not a blind spot."""
        if rec is None:
            rec = self.metrics.start_request(request.kind, 0, t_submit,
                                             trace_id=trace_id)
        if bill is None:
            bill = self.ledger.open(trace_id, uid, request.kind,
                                    replayed=replayed_from is not None)
        self.metrics.finish_request(rec, ok=False)
        self.ledger.close(bill, status=code, latency_s=rec.latency_s)
        if self.slo is not None:
            self.slo.observe(request.kind, rec.latency_s, False,
                             trace_id=trace_id)
        _TRACER.instant("request_error", trace_id=trace_id, uid=uid,
                        kind=request.kind, code=code)
        self.log.event(uid, "rejected", code=code, message=message)
        resp = error_response(uid, request.kind, code, message, t_submit,
                              trace_id=trace_id)
        resp.bill = bill.as_dict()
        return resp

    async def submit(self, request: Request,
                     on_partial: Optional[Callable] = None, *,
                     replayed_from: Optional[int] = None,
                     _replaces: Optional[int] = None,
                     _trace_id: Optional[str] = None) -> Response:
        """Submit one typed request; always returns a Response envelope
        (typed error inside on rejection — never an exception).

        ``on_partial(rows_done, n_rows)`` streams coalesced progress as
        the scheduler ticks through the request.  ``replayed_from`` /
        ``_replaces`` / ``_trace_id`` are the journal-replay path's
        internals (see :meth:`_replay_journal`); client code never
        passes them."""
        self._uid += 1
        uid = self._uid
        # the request-scoped correlation id: minted here at admission,
        # preserved verbatim across journal replay so one logical request
        # keeps ONE trace across process restarts.
        trace_id = _trace_id or mint_trace_id()
        t_submit = time.perf_counter()
        self.log.event(uid, "submit", kind=request.kind,
                       trace_id=trace_id)
        _TRACER.instant("request_admit", trace_id=trace_id, uid=uid,
                        kind=request.kind)
        if not self._accepting:
            self._journal_replaced(_replaces, SHUTTING_DOWN)
            return self._reject(uid, request, t_submit, trace_id,
                                SHUTTING_DOWN, "service is shutting down",
                                replayed_from)
        self._ensure_loop()
        try:
            active, items, cached = self._lower(uid, request, t_submit,
                                                on_partial, replayed_from,
                                                trace_id)
        except ServiceError as e:
            self._journal_replaced(_replaces, e.code)
            return self._reject(uid, request, t_submit, trace_id,
                                e.code, str(e), replayed_from)
        if cached is not None:
            self.metrics.finish_request(active.rec, ok=True, cached=True)
            bill_dict = self._close_bill(active, ok=True, status="ok",
                                         cache_hit=True)
            _TRACER.instant("request_done", trace_id=trace_id, uid=uid,
                            kind=request.kind, cached=True)
            self.log.event(uid, "cache_hit")
            self._journal_replaced(_replaces, "ok")
            now = time.perf_counter()
            return Response(request_id=uid, kind=request.kind, ok=True,
                            result=cached, cached=True,
                            timing=Timing(t_submit, now - t_submit,
                                          now - t_submit),
                            replayed=replayed_from is not None,
                            replayed_from=replayed_from,
                            trace_id=trace_id, bill=bill_dict)
        flood = self._fire("flood")
        if flood is not None or not self.sched.admit(items, active.cost):
            self.metrics.reject()
            self._journal_replaced(_replaces, QUEUE_FULL)
            return self._reject(
                uid, request, t_submit, trace_id, QUEUE_FULL,
                "pending row budget exhausted (injected flood)"
                if flood is not None else
                f"pending row budget exhausted "
                f"({self.sched.pending_rows}/{self.sched.max_pending} used, "
                f"request needs {active.cost})",
                replayed_from, rec=active.rec, bill=active.bill)
        for it in items:
            it.deadline_t = active.deadline_t
            it.trace_id = trace_id
        self._active[uid] = active
        if active.deadline_t is not None:
            self._deadline_count += 1
        if self.journal is not None:
            # the WAL write that makes this admission crash-safe — and
            # only AFTER it lands does the uid it replaces (if any) get
            # its "replayed" terminal: a crash between the two
            # duplicates work, never loses it.
            self.journal.admit(uid, request_to_wire(request, self.space),
                               origin=active.origin, trace_id=trace_id)
            if _replaces is not None:
                self.journal.done(_replaces, "replayed")
        self.log.event(uid, "admitted", rows=active.n_rows)
        if self._wake is not None:
            self._wake.set()
        try:
            return await active.future
        except asyncio.CancelledError:
            self._cancel(active)
            raise

    # ------------------------------------------------------------------
    # Lowering: request -> lane + work items + finalizers
    # ------------------------------------------------------------------

    def _mc_lane(self, flow: str, mc: McSpec, key_t: Tuple[int, int],
                 trace_id: str = "") -> Lane:
        """The Monte Carlo lane of ``mc`` under the key with host words
        ``key_t`` (the device key is uploaded from them, once a lane)."""
        quantiles = tuple(float(q) for q in mc.quantiles)
        draws = int(mc.draws)
        # admission-time warmup (span labelled with the forcing request)
        self._ensure_mc(flow, draws, quantiles, trace_id=trace_id)
        key_t = tuple(int(x) for x in key_t)
        sig_t = (mc.sigmas.defect_sigma, mc.sigmas.wafer_cost_sigma,
                 mc.sigmas.bond_sigma, mc.sigmas.interposer_sigma)
        lane = Lane(kind="mc", flow=flow, mc=(draws, quantiles, key_t, sig_t))
        # (key, sigma array, draws, quantiles) feed the fused dispatch;
        # the trailing Uncertainty object is for the legacy fallback.
        if lane not in self._lane_args:
            key = upload(np.asarray(key_t, np.int64), self.device)
            self._lane_args[lane] = (key, mc.sigmas.as_array(self.device),
                                     draws, quantiles, mc.sigmas)
        return lane

    def _check_flow(self, flow: str):
        if flow not in self.cfg.flows:
            raise ServiceError(
                INVALID_REQUEST,
                f"flow {flow!r} is not served (configured: {self.cfg.flows})")

    def _check_indices(self, indices, candidates=()) -> np.ndarray:
        if indices is None and candidates:
            try:
                indices = [self.space.index_of(c) for c in candidates]
            except ValueError as e:
                raise ServiceError(INVALID_REQUEST, str(e)) from None
        if indices is None:
            raise ServiceError(INVALID_REQUEST,
                               "request needs indices or candidates")
        idx = np.asarray(indices, np.int64)
        if idx.ndim != 1 or idx.size == 0:
            raise ServiceError(INVALID_REQUEST,
                               "need a 1-D, non-empty index vector")
        if idx.min() < 0 or idx.max() >= self.space.size():
            raise ServiceError(
                INVALID_REQUEST,
                f"candidate index out of range [0, {self.space.size()})")
        return idx

    def _alloc_sweep(self, active: _Active, idx: np.ndarray,
                     quantiles: Optional[Tuple[float, ...]]):
        n = int(idx.size)
        s = self.n_skus
        active.idx = idx
        active.n_rows = n
        active.cost = n
        active.accum = {"unit": np.empty((n, s), np.float32),
                        "re": np.empty((n, s), np.float32),
                        "nre": np.empty((n, s), np.float32),
                        "pf": np.empty((n,), np.float32)}
        active.degraded_rows = np.zeros((n,), bool)
        if quantiles is not None:
            active.risk_keys = _risk_keys(quantiles)
            for k in active.risk_keys:
                active.accum["risk:" + k] = np.empty((n,), np.float32)

    def _sweep_arrays(self, active: _Active) -> EvalArrays:
        risk = None
        if active.risk_keys:
            risk = {k: active.accum["risk:" + k] for k in active.risk_keys}
        return EvalArrays(idx=active.idx,
                          sku_unit_total=active.accum["unit"],
                          sku_unit_re=active.accum["re"],
                          sku_unit_nre=active.accum["nre"],
                          portfolio_cost=active.accum["pf"], risk=risk)

    def _lower(self, uid: int, request: Request, t_submit: float,
               on_partial, replayed_from: Optional[int] = None,
               trace_id: str = ""
               ) -> Tuple[_Active, List, Optional[object]]:
        kind = getattr(request, "kind", None)
        if kind is None:
            raise ServiceError(INVALID_REQUEST,
                               f"unknown request type {type(request)!r}")
        problem = validate_request(request)
        if problem is not None:
            raise ServiceError(INVALID_REQUEST, problem)
        self._check_flow(request.flow)
        fut = asyncio.get_running_loop().create_future()
        active = _Active(uid=uid, kind=kind, request=request,
                         rec=self.metrics.start_request(kind, 0, t_submit,
                                                        trace_id=trace_id),
                         future=fut, on_partial=on_partial,
                         replayed_from=replayed_from,
                         origin=(replayed_from if replayed_from is not None
                                 else uid))
        active.trace_id = trace_id
        active.bill = self.ledger.open(trace_id, uid, kind,
                                       replayed=replayed_from is not None)
        deadline_ms = getattr(request, "deadline_ms", None)
        if deadline_ms is not None:
            active.deadline_t = t_submit + float(deadline_ms) / 1e3

        if kind == "search":
            return self._lower_search(active, request)
        if kind == "price_systems":
            return self._lower_systems(active, request)

        # -- index-sweep family: price / rank / mc_risk / what_if ----------
        mc: Optional[McSpec] = getattr(request, "mc", None)
        if kind == "mc_risk":
            mc = request.mc
        grid_meta = None
        if kind == "what_if":
            idx, grid_meta, skipped = self._what_if_grid(request)
        elif kind == "rank" and request.indices is None:
            idx = np.arange(self.space.size(), dtype=np.int64)
        else:
            idx = self._check_indices(request.indices,
                                      getattr(request, "candidates", ()))
        quantiles = None
        if mc is not None:
            lane = self._mc_lane(
                request.flow, mc,
                prng.PRNGKey(mc.seed, device="cpu").tolist(),
                trace_id=trace_id)
            quantiles = tuple(float(q) for q in mc.quantiles)
        else:
            self._ensure_chunk(request.flow, trace_id=trace_id)
            lane = Lane(kind="chunk", flow=request.flow)

        objective = "cost"
        if kind == "rank":
            objective = request.objective
            if objective != "cost":
                if quantiles is None:
                    raise ServiceError(
                        INVALID_REQUEST,
                        f"objective {objective!r} needs an McSpec")
                if objective not in _risk_keys(quantiles):
                    raise ServiceError(
                        INVALID_REQUEST,
                        f"objective {objective!r} not among "
                        f"{_risk_keys(quantiles)}")

        self._alloc_sweep(active, idx, quantiles)
        active.rec.n_rows = active.n_rows

        if kind in ("price", "mc_risk"):
            active.payload_fn = lambda arrays: arrays
            active.cache_key = ResultCache.key(self.fingerprint,
                                               request.flow, lane.mc, idx)
        elif kind == "rank":
            top_k = int(request.top_k)
            active.payload_fn = \
                lambda arrays: self._rank_payload(arrays, objective, top_k)
            active.cache_key = ResultCache.key(self.fingerprint,
                                               request.flow, lane.mc, idx)
        else:  # what_if
            active.payload_fn = \
                lambda arrays, g=grid_meta, sk=skipped: \
                self._what_if_payload(arrays, g, sk)

        if active.cache_key is not None:
            hit = self.results.get(active.cache_key)
            if hit is not None:
                return active, [], active.payload_fn(hit)
        return active, [SpanWork(owner=active, lane=lane, idx=idx)], None

    def _rank_payload(self, arrays: EvalArrays, objective: str,
                      top_k: int) -> RankResult:
        obj = arrays.objective(objective)
        order = np.lexsort((arrays.idx, obj))   # index breaks exact ties
        top = order[:max(0, top_k)]
        risk = None
        if arrays.risk is not None:
            risk = {k: v[top] for k, v in arrays.risk.items()}
        top_arrays = EvalArrays(
            idx=arrays.idx[top], sku_unit_total=arrays.sku_unit_total[top],
            sku_unit_re=arrays.sku_unit_re[top],
            sku_unit_nre=arrays.sku_unit_nre[top],
            portfolio_cost=arrays.portfolio_cost[top], risk=risk)
        return RankResult(objective=objective,
                          order=arrays.idx[order], values=obj[order],
                          top=self.ev.results_from_arrays(top_arrays))

    # -- what-if -----------------------------------------------------------
    def _what_if_grid(self, request: WhatIfRequest):
        base = request.base
        if isinstance(base, (int, np.integer)):
            try:
                base = self.space.candidate_at(int(base))
            except IndexError as e:
                raise ServiceError(INVALID_REQUEST, str(e)) from None
        try:
            base_idx = self.space.index_of(base)
        except ValueError as e:
            raise ServiceError(INVALID_REQUEST, str(e)) from None
        procs = tuple(request.processes) or self.space.processes
        ints = tuple(request.integrations) or self.space.integrations
        grid, skipped = [], []
        for p in procs:
            for t in ints:
                try:
                    cand = self._swap_tech(base, p, t)
                    gi = self.space.index_of(cand)
                    grid.append((p, t, gi, cand.label()))
                except (ValueError, KeyError) as e:
                    skipped.append({"process": p, "integration": t,
                                    "reason": str(e)})
        if not grid:
            raise ServiceError(
                INVALID_REQUEST,
                f"no valid what-if combination (skipped {len(skipped)})")
        idx = np.asarray([base_idx] + [g[2] for g in grid], np.int64)
        return idx, (base.label(), grid), skipped

    @staticmethod
    def _swap_tech(cand: Candidate, process: str,
                   integration: str) -> Candidate:
        if cand.is_reuse:
            return Candidate(reuse=dataclasses.replace(
                cand.reuse, process=process, integration=integration))
        return Candidate(choices=tuple(
            ArchChoice(c.n_chiplets, process,
                       "SoC" if c.n_chiplets == 1 else integration)
            for c in cand.choices))

    def _what_if_payload(self, arrays: EvalArrays, grid_meta,
                         skipped) -> WhatIfResult:
        base_label, grid = grid_meta
        base_cost = float(arrays.portfolio_cost[0])
        rows = []
        for j, (p, t, gi, label) in enumerate(grid, start=1):
            cost = float(arrays.portfolio_cost[j])
            rows.append({"process": p, "integration": t, "candidate": label,
                         "portfolio_cost": cost,
                         "delta_vs_base": cost - base_cost,
                         "rel_delta": (cost - base_cost) / base_cost})
        return WhatIfResult(base_label=base_label, base_cost=base_cost,
                            rows=rows, skipped=list(skipped))

    # -- search ------------------------------------------------------------
    def _lower_search(self, active: _Active, sr: SearchRequest):
        if sr.population < 1 or not (1 <= sr.elite <= sr.population):
            raise ServiceError(INVALID_REQUEST,
                               "need 1 <= elite <= population")
        if sr.generations < 1:
            raise ServiceError(INVALID_REQUEST, "need generations >= 1")
        n_draws, quantile = 0, 0.5
        if sr.risk is not None:
            n_draws, quantile = int(sr.risk.n_draws), float(sr.risk.quantile)
        self._ensure_gen(sr.flow, SearchWarmup(
            population=sr.population, elite=sr.elite,
            jump_prob=float(sr.jump_prob), n_draws=n_draws,
            quantile=quantile), trace_id=active.trace_id)
        # the ranking sweep reuses the chunk/mc lane — make sure it's warm
        if sr.risk is not None:
            self._ensure_mc(sr.flow, n_draws, (0.5, quantile),
                            trace_id=active.trace_id)
        else:
            self._ensure_chunk(sr.flow, trace_id=active.trace_id)
        active.task = SearchTask(self, active, sr)
        if self.dcfg is not None and active.replayed_from is not None:
            # replayed search: continue from the newest readable
            # checkpoint (corrupt steps fall back; an unreadable tree
            # restarts from generation 0 — still bit-exact, just slower)
            mgr = self._ckpt_manager(active.origin)
            before = mgr.corrupt_fallbacks
            try:
                restored = SearchState.restore_latest(mgr, sr.population,
                                                      self.device)
            except ValueError:
                restored = None
            if mgr.corrupt_fallbacks > before:
                self.dur.bump("checkpoint_corrupt_fallbacks",
                              mgr.corrupt_fallbacks - before)
            if restored is not None:
                if not restored.trace_id:
                    # pre-tracing checkpoint: adopt the replayed trace
                    restored.trace_id = active.trace_id
                active.task.state = restored
                self.dur.bump("checkpoints_restored")
                self.log.event(active.uid, "search_restored",
                               origin=active.origin, gen=restored.gen)
                self.flight.record("search_restored", uid=active.uid,
                                   origin=active.origin, gen=restored.gen)
        # budget: every generation prices `population` rows, and the final
        # ranking sweep at most everything the generations saw.
        active.cost = sr.population * (sr.generations + 1)
        active.n_rows = 0             # set when the ranking sweep enqueues
        active.rec.n_rows = sr.population * sr.generations
        lane = Lane(kind="gen", flow=sr.flow)
        return active, [GenWork(owner=active, lane=lane,
                                task=active.task)], None

    def _enqueue_search_rank(self, active: _Active):
        """Generations done: stream the distinct priced candidates through
        the coalescing chunk/mc lane, exactly like portfolio_search's
        final ``evaluate_indices(uniq)`` sweep."""
        task, sr = active.task, active.task.sr
        uniq = task.uniq_indices()
        if sr.risk is not None:
            quantiles = (0.5, float(sr.risk.quantile))
            mc = McSpec(draws=int(sr.risk.n_draws), quantiles=quantiles,
                        seed=0, sigmas=sr.risk.sigmas)
            lane = self._mc_lane(sr.flow, mc, task.mc_key_words,
                                 trace_id=active.trace_id)
        else:
            quantiles = None
            lane = Lane(kind="chunk", flow=sr.flow)
        self._alloc_sweep(active, uniq, quantiles)
        active.cost = sr.population * (sr.generations + 1)  # unchanged
        active.payload_fn = task.finalize
        self.sched.push(SpanWork(owner=active, lane=lane, idx=uniq,
                                 deadline_t=active.deadline_t,
                                 trace_id=active.trace_id))

    # -- raw spec lane ------------------------------------------------------
    def _lower_systems(self, active: _Active, req: PriceSystemsRequest):
        if self.cfg.raw_slots < 1:
            raise ServiceError(INVALID_REQUEST,
                               "raw system lane is disabled (raw_slots=0)")
        if not req.specs:
            raise ServiceError(INVALID_REQUEST, "empty spec list")
        if len(req.specs) > self.cfg.raw_slots:
            raise ServiceError(
                INVALID_REQUEST,
                f"group of {len(req.specs)} systems exceeds the raw lane "
                f"budget of {self.cfg.raw_slots}")
        try:
            systems = [spec(dict(d)) for d in req.specs]
            for s in systems:
                if s.n_chips > self.raw_max_chips:
                    raise ValueError(
                        f"system {s.name!r} has {s.n_chips} chips "
                        f"(raw lane limit {self.raw_max_chips})")
            # dry-run the solo pack: catches duplicate names, bad specs
            solo = self._pack_raw(systems, [0] * len(systems))
            if not self._raw_fits(solo):
                raise ValueError("group exceeds the raw lane entity budget")
        except (ValueError, KeyError, TypeError) as e:
            raise ServiceError(INVALID_REQUEST, str(e)) from None
        self._ensure_raw(req.flow, trace_id=active.trace_id)
        active.n_rows = len(systems)
        active.cost = len(systems)
        active.rec.n_rows = len(systems)
        lane = Lane(kind="raw", flow=req.flow)
        return active, [GroupWork(owner=active, lane=lane,
                                  systems=systems)], None

    def _raw_fits(self, batch: SystemBatch) -> bool:
        p = self.raw_pad
        return (len(batch) <= p["n_systems"]
                and batch.chip_area.shape[1] <= p["max_chips"]
                and batch.chip_entity_area.shape[0] <= p["chip_entities"]
                and batch.pkg_entity_area.shape[0] <= p["pkg_entities"]
                and batch.mod_entity_area.shape[0] <= p["mod_entities"]
                and batch.mod_sys.shape[0] <= p["mod_instances"]
                and batch.d2d_entity_nre.shape[0] <= p["d2d_entities"]
                and batch.d2d_sys.shape[0] <= p["d2d_instances"])

    # ------------------------------------------------------------------
    # The tick: one lane, one dispatch, ONE device-to-host copy
    # ------------------------------------------------------------------

    def _tick(self) -> bool:
        if self.faults and self._fire("crash") is not None:
            self._hard_crash()
            return False
        if self._deadline_count:
            now = time.perf_counter()
            for w in self.sched.expire(now):
                owner: _Active = w.owner
                if owner.failed:
                    continue
                self.res.bump("deadline_rejected")
                self._fail(owner, DEADLINE_EXCEEDED,
                           f"deadline exceeded after "
                           f"{(now - owner.rec.t_submit) * 1e3:.1f} ms "
                           f"({owner.rows_done}/{owner.n_rows} rows done)")
        plan = self.sched.plan()
        if plan is None:
            return False
        # terminal completions discovered during the tick are DEFERRED to
        # after the wall clock stops and the ledger charges the tick, so
        # a finishing request's bill includes its final tick's share.
        self._tick_done = []
        self._raw_parts = None
        span_labels: Dict[str, object] = {"lane": plan.lane.kind}
        if _TRACER.enabled():
            tids, seen = [], set()
            for owner in self._owners(plan):
                if owner.trace_id and owner.trace_id not in seen:
                    seen.add(owner.trace_id)
                    tids.append(owner.trace_id)
            span_labels["trace_ids"] = tids
        t0 = time.perf_counter()
        before = self.traces.counts()
        retries_before = self.res.retries
        dispatch_before = (torchhooks.total_dispatch_s()
                           if _TRACER.enabled() else 0.0)
        if self.watchdog is not None:
            self.watchdog.enter()
        try:
            with _TRACER.span("tick", **span_labels):
                stall = self._fire("stall")
                if stall is not None:
                    time.sleep(stall.ms / 1e3)
                try:
                    if plan.gen is not None:
                        rows = self._tick_gen(plan)
                    elif plan.lane.kind == "raw":
                        rows = self._tick_raw(plan)
                    else:
                        rows = self._tick_chunk(plan)
                except Exception as e:  # fail the owners, keep serving
                    self._fail_tick(plan, e)
                    rows = 0
        finally:
            if self.watchdog is not None:
                self.watchdog.exit()
        recompiled = self.traces.meter_tick(before)
        wall = time.perf_counter() - t0
        # gen lanes price their whole population every tick: count those
        # rows as fully-occupied slots so search work shows up in
        # occupancy instead of being excluded (see ServiceMetrics).
        slots, used = plan.slots, plan.used
        if plan.lane.kind == "gen":
            slots = used = rows
        dispatch_s = ((torchhooks.total_dispatch_s() - dispatch_before)
                      if _TRACER.enabled() else 0.0)
        self.ledger.charge_tick(plan.lane.kind, wall,
                                self._tick_parts(plan),
                                slots or 1, used,
                                dispatch_s=dispatch_s,
                                retries=self.res.retries - retries_before)
        self.metrics.record_tick(plan.lane.kind, slots, used, rows, wall)
        self.flight.record("tick", lane=plan.lane.kind, slots=slots,
                           used=used, rows=rows, wall_s=wall,
                           recompiled=bool(recompiled))
        if recompiled:
            self.log.event(-1, "tick_recompile", lane=plan.lane.kind,
                           traces=recompiled)
        done, self._tick_done = self._tick_done, []
        for fin in done:
            fin()
        return True

    def _tick_parts(self, plan: TickPlan) -> List[Tuple[Bill, int]]:
        """(bill, rows contributed) per request for this tick — the
        pro-ration weights :meth:`Ledger.charge_tick` splits the wall
        over.  A coalesced owner with several assignments (multi-pass
        fill) appears once, with its rows summed."""
        if plan.gen is not None:
            owner = plan.gen.owner
            if owner.bill is None:
                return []
            return [(owner.bill, max(1, owner.task.sr.population))]
        if plan.lane.kind == "raw":
            groups = self._raw_parts if self._raw_parts is not None \
                else plan.groups
            return [(g.owner.bill, g.n_systems) for g in groups
                    if g.owner.bill is not None]
        parts: List[Tuple[Bill, int]] = []
        pos: Dict[int, int] = {}
        for a in plan.assignments:
            bill = a.item.owner.bill
            if bill is None:
                continue
            if id(bill) in pos:
                old_bill, old_n = parts[pos[id(bill)]]
                parts[pos[id(bill)]] = (old_bill, old_n + a.n)
            else:
                pos[id(bill)] = len(parts)
                parts.append((bill, a.n))
        return parts

    def _owners(self, plan: TickPlan) -> List[_Active]:
        owners = []
        if plan.gen is not None:
            owners.append(plan.gen.owner)
        owners += [a.item.owner for a in plan.assignments]
        owners += [g.owner for g in plan.groups]
        return owners

    def _fail_tick(self, plan: TickPlan, err: Exception):
        self.flight.record("tick_error", lane=plan.lane.kind,
                           error=f"{type(err).__name__}: {err}")
        if FlightRecorder.auto_dump_dir() is not None:
            try:
                self.dump_flight_recorder()
            except OSError:
                pass                      # never let a dump kill serving
        seen = set()
        for owner in self._owners(plan):
            if id(owner) in seen:
                continue
            seen.add(id(owner))
            self._fail(owner, INTERNAL_ERROR,
                       f"{type(err).__name__}: {err}")

    def _dispatch_fused(self, lane: Lane, dev):
        """One fused chunk dispatch + host fetch (may raise): the chunk's
        outputs packed into one tensor, read back in one copy, as host
        views ``(unit, re, nre, pf, risk, finite)``."""
        mc = lane.kind == "mc"
        if self.faults:
            if self._fire("recompile") is not None:
                # the fused probe forgets its seen signatures: the
                # dispatch below survives as a first call and gets
                # metered as a tick recompile.
                (_CHUNK_MC_PROBE if mc else _CHUNK_PROBE).forget()
            if self._fire("dispatch_error") is not None:
                raise InjectedFault("dispatch_error")
        if mc:
            key, sig, draws, quantiles = self._lane_args[lane][:4]
            out = _CHUNK_MC_PROBE(self.tables, dev, self.qty, key, sig,
                                  meta=self.enc.meta, flow=lane.flow,
                                  n_draws=draws, quantiles=quantiles)
        else:
            out = _CHUNK_PROBE(self.tables, dev, self.qty,
                               meta=self.enc.meta, flow=lane.flow)
        packed, risk_keys = pack_rows(out)
        host = torchhooks.to_host(packed)          # THE tick sync
        return unpack_rows(host, self.n_skus, risk_keys)

    def _dispatch_fused_with_retry(self, lane: Lane, dev):
        """Returns ``(host, None)`` or, with the retry budget spent,
        ``(None, last_error)`` — the caller decides fallback vs raise."""
        last: Optional[Exception] = None
        for attempt in range(1 + max(0, self.cfg.tick_retries)):
            if attempt:
                self.res.bump("retries")
                time.sleep(self.cfg.retry_backoff_s * attempt)
            try:
                return self._dispatch_fused(lane, dev), None
            except Exception as e:  # noqa: BLE001 - retry any failure
                self.res.bump("fused_failures")
                last = e
                self.log.event(-1, "fused_dispatch_error", lane=lane.kind,
                               attempt=attempt,
                               error=f"{type(e).__name__}: {e}")
                self.flight.record("fused_dispatch_error", lane=lane.kind,
                                   attempt=attempt,
                                   error=f"{type(e).__name__}: {e}")
        return None, last

    def _fallback_chunk_host(self, lane: Lane, chunk_idx: np.ndarray):
        """Degraded-mode tick: price the (already padded) chunk through
        the legacy host-packing oracle.  Returns host arrays in the
        fused layout ``(unit, re, nre, pf[, risk], finite)`` — float32
        casts of the oracle's float64s, bit-exact vs ``_evaluate_legacy``
        by shared :meth:`ChunkedEvaluator._legacy_chunk_host` math."""
        ev = self._fallback_evaluator(lane.flow)
        with _TRACER.span("fallback", lane=lane.kind):
            if lane.kind == "mc":
                key, _, draws, quantiles, sigmas = self._lane_args[lane]
                arrays = ev.evaluate_indices_legacy(
                    chunk_idx, mc_key=key, mc_draws=draws,
                    mc_sigmas=sigmas, mc_quantiles=quantiles)
            else:
                arrays = ev.evaluate_indices_legacy(chunk_idx)
        out = [arrays.sku_unit_total, arrays.sku_unit_re,
               arrays.sku_unit_nre, arrays.portfolio_cost]
        if arrays.risk is not None:
            out.append(arrays.risk)
        out.append(arrays.finite)
        return tuple(out)

    def _tick_chunk(self, plan: TickPlan) -> int:
        k = self.cfg.chunk
        with _TRACER.span("pack", used=plan.used):
            chunk_idx = np.zeros((k,), np.int64)
            for a in plan.assignments:
                chunk_idx[a.slot:a.slot + a.n] = \
                    a.item.idx[a.start:a.start + a.n]
            if plan.used < k and plan.assignments:
                chunk_idx[plan.used:] = chunk_idx[0]  # cost-neutral padding
            # pinned and non-blocking: nothing before the copy syncs
            dev = upload(chunk_idx.astype(np.int32), self.device)
        host = None
        degraded = False
        if self.breaker.allow():
            host, err = self._dispatch_fused_with_retry(plan.lane, dev)
            if host is None:
                self.breaker.record_failure()
                if not self.cfg.fallback:
                    raise err
            else:
                self.breaker.record_success()
        if host is None:
            # fused path down (or breaker open): slow-but-correct.
            t_fb = time.perf_counter()
            host = self._fallback_chunk_host(plan.lane, chunk_idx)
            degraded = True
            self.res.bump("fallback_ticks")
            self.res.bump("fallback_rows", plan.used)
            self.res.bump("fallback_busy_s", time.perf_counter() - t_fb)
        now = time.perf_counter()
        unit, re_t, nre_t, pf = host[0], host[1], host[2], host[3]
        risk = host[4] if plan.lane.kind == "mc" else None
        finite = np.asarray(host[-1])
        if self.faults and plan.used \
                and self._fire("poison") is not None:
            # write into copies: the host views share one packed buffer
            unit = np.array(unit)
            finite = np.array(finite)
            row = self.faults.rng(
                "poison", self.faults.fired["poison"]).randrange(plan.used)
            unit[row] = np.nan
            finite[row] = False
        for a in plan.assignments:
            req: _Active = a.item.owner
            if req.failed:
                continue
            sl = slice(a.slot, a.slot + a.n)
            dst = slice(a.start, a.start + a.n)
            ok_rows = finite[sl]
            if not ok_rows.all():
                # a typed envelope for THIS request only; coalesced
                # siblings in the same chunk are untouched.
                bad = int(a.n - ok_rows.sum())
                self.res.bump("numerical_errors")
                self._fail(req, NUMERICAL_ERROR,
                           f"non-finite cost in {bad} of {a.n} rows "
                           f"(rows {a.start}..{a.start + a.n - 1})")
                continue
            req.accum["unit"][dst] = unit[sl]
            req.accum["re"][dst] = re_t[sl]
            req.accum["nre"][dst] = nre_t[sl]
            req.accum["pf"][dst] = pf[sl]
            if risk is not None:
                for kk in req.risk_keys:
                    req.accum["risk:" + kk][dst] = risk[kk][sl]
            if degraded:
                req.degraded = True
                req.degraded_rows[dst] = True
            if not req.rec.t_first:
                req.rec.t_first = now
            req.rows_done += a.n
            if req.on_partial is not None:
                req.on_partial(req.rows_done, req.n_rows)
            if req.rows_done >= req.n_rows:
                # defer past charge_tick so the final tick's share is on
                # the bill before the response envelope snapshots it
                self._tick_done.append(
                    lambda r=req: self._finish_sweep(r))
        if _TRACER.enabled():
            _TRACER.add_complete("scatter", time.perf_counter() - now)
        return plan.used

    def _tick_gen(self, plan: TickPlan) -> int:
        work: GenWork = plan.gen
        req: _Active = work.owner
        if req.failed:
            return 0
        task = work.task
        # a restored checkpoint may already have every generation done
        # (the crash hit between the last generation and the ranking
        # sweep): go straight to ranking.
        if task.gen >= task.sr.generations:
            self._enqueue_search_rank(req)
            return 0
        # checkpointed abort: a search checks its deadline between
        # generations (queue expiry catches it too once re-pushed, but
        # plan() may have popped this work before the deadline passed).
        if req.deadline_t is not None \
                and time.perf_counter() >= req.deadline_t:
            self.res.bump("deadline_rejected")
            self._fail(req, DEADLINE_EXCEEDED,
                       f"deadline exceeded after {task.gen}/"
                       f"{task.sr.generations} generations")
            return 0
        with _TRACER.span("generation", gen=task.gen):
            try:
                out = task.device_call()
                host = _read_generation(*out)      # THE tick sync
            except Exception as e:
                self._fail(req, INTERNAL_ERROR, f"{type(e).__name__}: {e}")
                return 0
            if not np.isfinite(np.asarray(host[2], np.float64)).all():
                self.res.bump("numerical_errors")
                self._fail(req, NUMERICAL_ERROR,
                           f"non-finite objective in generation {task.gen}")
                return 0
            if not req.rec.t_first:
                req.rec.t_first = time.perf_counter()
            done = task.consume(host)
            if self.dcfg is not None and not done \
                    and self.dcfg.checkpoint_every > 0 \
                    and task.gen % self.dcfg.checkpoint_every == 0:
                try:
                    task.state.save(self._ckpt_manager(req.origin))
                    self.dur.bump("checkpoints_written")
                except OSError as e:
                    self.log.event(req.uid, "checkpoint_error",
                                   error=str(e))
            if req.on_partial is not None:
                req.on_partial(task.gen, task.sr.generations)
            if done:
                self._enqueue_search_rank(req)
            else:
                self.sched.push(work)
        return task.sr.population

    def _tick_raw(self, plan: TickPlan) -> int:
        with _TRACER.span("pack", lane="raw"):
            groups = list(plan.groups)
            # combined entity tables must fit the padded signature; shed
            # the newest groups back to the queue head until they do.
            while groups:
                systems, gids = [], []
                for gi, g in enumerate(groups):
                    systems += g.systems
                    gids += [gi] * g.n_systems
                batch = self._pack_raw(systems, gids)
                if self._raw_fits(batch):
                    break
                self.sched.queue.appendleft(groups.pop())
            if not groups:
                return 0
            self._raw_parts = list(groups)   # actual riders after shedding
        host = self._price_raw(batch, plan.lane.flow)      # THE sync
        now = time.perf_counter()
        total = np.asarray(host[0], np.float64)
        re_tot = np.asarray(host[1], np.float64)
        nre_tot = np.asarray(host[2], np.float64)
        off = 0
        for g in groups:
            req: _Active = g.owner
            rows = []
            for i, s in enumerate(g.systems):
                j = off + i
                rows.append({"system": s.name, "quantity": s.quantity,
                             "re_total": float(re_tot[j]),
                             "nre_total": float(nre_tot[j]),
                             "total": float(total[j])})
            off += g.n_systems
            if req.failed:
                continue
            group_sl = slice(off - g.n_systems, off)
            if not (np.isfinite(total[group_sl]).all()
                    and np.isfinite(re_tot[group_sl]).all()
                    and np.isfinite(nre_tot[group_sl]).all()):
                self.res.bump("numerical_errors")
                self._fail(req, NUMERICAL_ERROR,
                           f"non-finite cost in the {g.n_systems}-system "
                           f"group")
                continue
            req.rec.t_first = req.rec.t_first or now
            req.rows_done = req.n_rows
            self._tick_done.append(
                lambda r=req, p=SystemsResult(rows=rows): self._finish(r, p))
        if _TRACER.enabled():
            _TRACER.add_complete("scatter", time.perf_counter() - now)
        return off

    # ------------------------------------------------------------------
    # Completion / failure
    # ------------------------------------------------------------------

    def _finish_sweep(self, req: _Active):
        try:
            arrays = self._sweep_arrays(req)
            # degraded (fallback-priced) values are correct but carry a
            # different provenance than fused ones — never cache them.
            if req.cache_key is not None and not req.degraded:
                self.results.put(req.cache_key, arrays)
            payload = req.payload_fn(arrays)
        except Exception as e:
            self._fail(req, INTERNAL_ERROR, f"{type(e).__name__}: {e}")
            return
        self._finish(req, payload)

    def _finish(self, req: _Active, payload):
        if req.deadline_t is not None:
            self._deadline_count -= 1
        self.metrics.finish_request(req.rec, ok=True)
        bill_dict = self._close_bill(req, ok=True, status="ok")
        self.sched.release(req.cost)
        self._active.pop(req.uid, None)
        if self.journal is not None:
            self.journal.done(req.uid, "ok")
        if req.kind == "search":
            self._drop_checkpoints(req.origin)
        _TRACER.instant("request_done", trace_id=req.trace_id,
                        uid=req.uid, kind=req.kind)
        self.log.event(req.uid, "done", rows=req.n_rows,
                       degraded=req.degraded)
        self.flight.record("request", uid=req.uid, kind=req.kind,
                           rows=req.n_rows, wall_s=req.rec.latency_s,
                           degraded=req.degraded, trace_id=req.trace_id)
        if not req.future.done():
            req.future.set_result(Response(
                request_id=req.uid, kind=req.kind, ok=True, result=payload,
                timing=Timing(req.rec.t_submit, req.rec.ttfr_s,
                              req.rec.latency_s),
                degraded=req.degraded,
                degraded_rows=(req.degraded_rows
                               if req.degraded
                               and req.kind in ("price", "mc_risk")
                               else None),
                replayed=req.replayed_from is not None,
                replayed_from=req.replayed_from,
                trace_id=req.trace_id, bill=bill_dict))

    def _fail(self, req: _Active, code: str, message: str):
        if req.failed:
            return
        req.failed = True
        if req.deadline_t is not None:
            self._deadline_count -= 1
        self.sched.drop_owned_by(req)
        self.sched.release(req.cost)
        self.metrics.finish_request(req.rec, ok=False)
        bill_dict = self._close_bill(req, ok=False, status=code)
        self._active.pop(req.uid, None)
        if self.journal is not None:
            # a typed failure IS an answer: terminal in the journal, so
            # the request will not replay.
            self.journal.done(req.uid, code)
        _TRACER.instant("request_error", trace_id=req.trace_id,
                        uid=req.uid, kind=req.kind, code=code)
        self.log.event(req.uid, "error", code=code, message=message)
        self.flight.record("request_error", uid=req.uid, kind=req.kind,
                           code=code, error=message, trace_id=req.trace_id)
        if not req.future.done():
            resp = error_response(req.uid, req.kind, code, message,
                                  req.rec.t_submit, trace_id=req.trace_id)
            resp.replayed = req.replayed_from is not None
            resp.replayed_from = req.replayed_from
            resp.bill = bill_dict
            req.future.set_result(resp)

    # ------------------------------------------------------------------
    # Observability
    # ------------------------------------------------------------------

    def snapshot(self) -> Dict:
        """JSON-ready metrics snapshot (latency, occupancy, caches,
        recompiles) — the surface the bench and CI assert on, with the
        reference's keys.  When tracing is on (``REPRO_TRACE=1`` /
        ``obs.enable()``) the snapshot also carries the per-phase wall
        table, the per-probe first-call/dispatch attribution (``jit``)
        and the ``to_host`` stats (``device_get``)."""
        snap = self.metrics.snapshot(trace_stats=self.traces.stats(),
                                     cache_stats=self.results.stats())
        snap["resilience"] = {
            **self.res.snapshot(),
            "breaker": self.breaker.snapshot(),
            "faults": self.faults.stats(),
            "deadlines_active": self._deadline_count,
            "watchdog": (self.watchdog.snapshot()
                         if self.watchdog is not None else None),
        }
        snap["durability"] = {
            **self.dur.snapshot(),
            "enabled": self.dcfg is not None,
            "accepting": self._accepting,
            "journal": (self.journal.stats()
                        if self.journal is not None else None),
        }
        snap["ledger"] = self.ledger.snapshot()
        snap["slo"] = ({"enabled": True, "objectives": self.slo.snapshot()}
                       if self.slo is not None else {"enabled": False})
        if _TRACER.enabled():
            snap["obs"] = {
                "phases": _TRACER.phase_table(),
                "tick_coverage": _TRACER.coverage("tick"),
                "jit": torchhooks.stats(),
                "device_get": torchhooks.device_get_stats(),
                "recompiles_in_ticks": (
                    _TRACER.count("jit_compile", parent="tick")
                    + _TRACER.count("jit_compile", parent="generation")
                    + _TRACER.count("jit_compile", parent="pack")),
            }
        return snap

    def dump_flight_recorder(self, path=None):
        """Dump the flight recorder — and, when tracing is on, every
        tracer span — as one Chrome/Perfetto ``trace_event`` JSON file.
        Called automatically on tick failure when ``REPRO_FLIGHT_DIR``
        is set; callable any time for a live look at recent ticks.
        Returns the written path."""
        extra = _TRACER.chrome_events() if _TRACER.enabled() else None
        return self.flight.dump(path, extra_events=extra)


def serve(space: DesignSpace, requests: Sequence[Request],
          config: Optional[ServiceConfig] = None, *, device=None,
          ) -> Tuple[List[Response], PricingService]:
    """One-shot convenience: start a service on ``device`` (the GPU unless
    the caller names another), submit ``requests`` concurrently, drain,
    stop.  Returns (responses in request order, the stopped service for
    metrics inspection)."""
    svc = PricingService(space, config, device=device)

    async def _main():
        await svc.start()
        try:
            return await asyncio.gather(*(svc.submit(r) for r in requests))
        finally:
            await svc.stop()

    return asyncio.run(_main()), svc
