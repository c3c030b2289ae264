"""Portfolio optimizer: evolutionary search over the candidate space.

The counterpart of ``repro.dse.search``.  Answers "what is the cheapest
multi-chiplet architecture for this SKU portfolio at these volumes?" —
optionally under parameter uncertainty, where the objective becomes a
high quantile of the Monte Carlo portfolio cost and the result carries a
cost-vs-risk Pareto front.

The loop is a (mu + lambda) evolutionary search with elitism, and its
inner iteration is ONE **generation step** on the device: decode the
population indices (:func:`~repro_torch.dse.space.encode_arrays`), price
them with the engine, reduce to the (possibly Monte-Carlo-quantile)
objective, rank with a stable sort, and breed the next population with
vectorized index-space crossover + mutation.  The host reads back once
per generation, for history bookkeeping; nothing per-candidate crosses
the device boundary.

All randomness flows from one explicit threefry key
(:mod:`repro_torch.random`), drawn exactly as the JAX package draws it,
so the same key gives the same populations and winner in both packages.
For brute-forceable spaces, :func:`exhaustive_search` enumerates — the
cross-check that the evolutionary loop recovers the true optimum.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import random as prng
from .. import resolve_device
from ..checkpoint.store import CheckpointManager
from ..core.engine import portfolio_totals
from ..core.explorer import pareto_front
from ..obs import torchhooks
from ..obs.trace import TRACER as _TRACER
from .evaluate import (CandidateResult, ChunkedEvaluator, _fused_risk_draws,
                       _fused_totals)
from .space import DesignSpace, EncoderMeta
from .uncertainty import Uncertainty, portfolio_risk_stats


@dataclasses.dataclass(frozen=True)
class RiskConfig:
    """Turns the search uncertainty-aware: optimize a cost quantile."""

    n_draws: int = 128
    sigmas: Uncertainty = dataclasses.field(default_factory=Uncertainty)
    quantile: float = 0.9

    @property
    def objective_key(self) -> str:
        return f"q{int(round(self.quantile * 100))}"


@dataclasses.dataclass
class SearchResult:
    best: CandidateResult
    ranked: List[CandidateResult]      # every priced candidate, best first
    pareto: List[Dict]                 # cost-vs-risk front (risk runs only)
    history: List[Dict]                # per-generation progress
    n_evaluated: int                   # distinct candidates priced
    objective_key: str = "cost"

    def top(self, k: int = 10) -> List[CandidateResult]:
        return self.ranked[:k]


def _rank(results: Sequence[CandidateResult], key: str
          ) -> List[CandidateResult]:
    # label is the deterministic tie-breaker: equal-cost candidates
    # always rank in the same order regardless of arrival order.
    return sorted(results, key=lambda r: (r.objective(key), r.label))


def _front(results: Sequence[CandidateResult], key: str) -> List[Dict]:
    if key == "cost":
        return []
    pts = [{"label": r.label, "mean": r.risk["mean"], key: r.risk[key],
            "candidate": r.candidate} for r in results if r.risk]
    return pareto_front(pts, "mean", key)


def _check_evaluator(space: DesignSpace, flow: str,
                     ev: ChunkedEvaluator) -> ChunkedEvaluator:
    """A passed-in evaluator must agree with the search's space/flow —
    it binds both, and a mismatch would silently price the wrong
    portfolio."""
    if ev.space != space:
        raise ValueError("evaluator was built for a different DesignSpace")
    if ev.flow != flow:
        raise ValueError(
            f"evaluator flow {ev.flow!r} != requested flow {flow!r}")
    return ev


def _mc_kwargs(risk: RiskConfig, mc_key) -> Dict:
    return dict(mc_key=mc_key, mc_draws=risk.n_draws, mc_sigmas=risk.sigmas,
                mc_quantiles=(0.5, risk.quantile))


def _default_mc_key(key):
    """The one shared derivation of the Monte Carlo key from a search key:
    exhaustive and evolutionary runs given the same ``key`` price every
    candidate under identical scenarios, so their quantile objectives are
    directly comparable (common random numbers)."""
    return prng.fold_in(key, 1)


# ---------------------------------------------------------------------------
# Search state: the checkpointable loop carrier
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SearchState:
    """Everything the evolutionary loop needs to continue from
    generation ``gen`` — and nothing else.

    Because the key schedule is ``k_loop, k_gen = split(k_loop)`` each
    generation and the final ranking sweep depends only on ``seen`` and
    ``mc_key``, restoring this state reproduces an uninterrupted run
    bit-exactly: same populations, same history floats, same ranked
    result.

    The tensor leaves (``pop``/``k_loop``/``mc_key``/``sig``) have fixed
    shapes given the population, so they ride
    :mod:`repro_torch.checkpoint.store`'s array protocol, keys as the
    ``uint32[2]`` the JAX package writes; the variable-size host state
    (``seen``, ``history``, best-so-far) travels in the manifest's
    ``extra`` JSON, which roundtrips Python floats exactly.  A state the
    JAX package checkpointed resumes here, and the other way round.
    """

    pop: Any                       # (population,) int32 candidate indices
    k_loop: Any                    # (2,) int64 loop PRNG key
    mc_key: Any                    # (2,) int64 Monte-Carlo key
    sig: Any                       # (4,) float32 sigma vector
    seen: set
    history: List[Dict]
    best_obj: float = np.inf
    best_idx: int = -1
    gen: int = 0                   # completed generations
    trace_id: str = ""             # request trace id (rides the manifest)

    @classmethod
    def init(cls, key, population: int, size: int,
             risk: Optional[RiskConfig]) -> "SearchState":
        """The one shared derivation of a fresh search state from a PRNG
        key, on the key's device."""
        mc_key = key
        sig = torch.zeros((4,), dtype=torch.float32, device=key.device)
        if risk is not None:
            mc_key = _default_mc_key(key)
            sig = risk.sigmas.as_array(key.device)
        k_init, k_loop = prng.split(key).unbind(0)
        pop = prng.randint(k_init, (population,), 0, size)
        return cls(pop=pop, k_loop=k_loop, mc_key=mc_key, sig=sig,
                   seen=set(), history=[])

    def consume(self, host, label_fn) -> None:
        """Fold one generation's host results (priced population, gen
        best index/objective) into the state."""
        pop_h, gen_idx, gen_obj = host
        self.seen.update(int(i) for i in pop_h)
        if float(gen_obj) < self.best_obj:
            self.best_obj, self.best_idx = float(gen_obj), int(gen_idx)
        self.history.append({
            "generation": self.gen,
            "evaluated": len(self.seen),
            "best_objective": self.best_obj,
            "best_label": label_fn(self.best_idx),
            "gen_best": float(gen_obj)})
        self.gen += 1

    # -- checkpoint protocol -------------------------------------------------

    def tree(self) -> Dict[str, Any]:
        return {"pop": self.pop, "k_loop": self.k_loop.to(torch.uint32),
                "mc_key": self.mc_key.to(torch.uint32), "sig": self.sig}

    def extra(self) -> Dict[str, Any]:
        return {"gen": self.gen, "best_obj": float(self.best_obj),
                "best_idx": int(self.best_idx),
                "trace_id": self.trace_id,
                "seen": sorted(int(i) for i in self.seen),
                "history": list(self.history)}

    @staticmethod
    def like(population: int, device="cpu") -> Dict[str, Any]:
        """The fixed-shape restore template for a given population."""
        return {"pop": torch.zeros((population,), dtype=torch.int32,
                                   device=device),
                "k_loop": torch.zeros((2,), dtype=torch.uint32,
                                      device=device),
                "mc_key": torch.zeros((2,), dtype=torch.uint32,
                                      device=device),
                "sig": torch.zeros((4,), dtype=torch.float32, device=device)}

    def save(self, manager: CheckpointManager):
        """Publish this state as checkpoint step ``gen`` (atomic
        rename, digest-stamped, retention-K via the manager)."""
        return manager.save(self.gen, self.tree(), extra=self.extra())

    @classmethod
    def restore_latest(cls, manager: CheckpointManager, population: int,
                       device="cpu") -> Optional["SearchState"]:
        """Newest readable checkpoint as a live state on ``device``, or
        None when the directory holds none.  Corrupt steps fall back to
        the previous retained step (``manager.corrupt_fallbacks`` counts
        them)."""
        step, tree = manager.restore_latest(cls.like(population, device))
        if step is None:
            return None
        manifest = manager.directory / f"step_{step:08d}" / "manifest.json"
        extra = json.loads(manifest.read_text()).get("extra", {})
        return cls(pop=tree["pop"], k_loop=prng.as_key(tree["k_loop"]),
                   mc_key=prng.as_key(tree["mc_key"]), sig=tree["sig"],
                   seen=set(int(i) for i in extra.get("seen", [])),
                   history=list(extra.get("history", [])),
                   best_obj=float(extra.get("best_obj", np.inf)),
                   best_idx=int(extra.get("best_idx", -1)),
                   gen=int(extra.get("gen", step)),
                   trace_id=str(extra.get("trace_id", "")))


def exhaustive_search(space: DesignSpace,
                      evaluator: Optional[ChunkedEvaluator] = None,
                      flow: str = "chip-last",
                      risk: Optional[RiskConfig] = None,
                      mc_key=None, key=None, device=None) -> SearchResult:
    """Price every candidate in the space (small spaces only).

    In risk mode the Monte Carlo scenarios come from ``mc_key`` (or are
    derived from ``key`` exactly as :func:`portfolio_search` does, so
    passing the same ``key`` to both makes their quantile objectives
    comparable).  Prices on the evaluator's device, else on ``device``
    (the GPU unless the caller names another).
    """
    ev = _check_evaluator(space, flow, evaluator) if evaluator \
        else ChunkedEvaluator(space, flow=flow, device=device)
    kw = {}
    obj = "cost"
    if risk is not None:
        if mc_key is None:
            base = prng.as_key(key, ev.device) if key is not None \
                else prng.PRNGKey(0, device=ev.device)
            mc_key = _default_mc_key(base)
        kw = _mc_kwargs(risk, mc_key)
        obj = risk.objective_key
    results = ev.evaluate(list(space.enumerate_candidates()), **kw)
    ranked = _rank(results, obj)
    return SearchResult(best=ranked[0], ranked=ranked,
                        pareto=_front(results, obj), history=[],
                        n_evaluated=len(results), objective_key=obj)


# ---------------------------------------------------------------------------
# Vectorized index-space genetic operators (pure torch, static meta)
# ---------------------------------------------------------------------------


def _digits(i, meta: EncoderMeta, pows):
    """(n,) arch index -> (n, S) per-SKU choice digits (SKU 0 is most
    significant), garbage-but-bounded for reuse indices (callers mask)."""
    safe = torch.where(i >= meta.n_arch, 0, i)
    return (safe[:, None] // pows[None, :]) % meta.n_arch_choices


def _compose(digits, pows):
    return (digits * pows[None, :]).sum(-1).to(torch.int32)


def _crossover_vec(key, ia, ib, meta: EncoderMeta, pows):
    """Per-SKU uniform crossover of two index vectors; any reuse parent
    passes through (mutation supplies reuse-family exploration)."""
    picks = prng.bernoulli(key, 0.5, tuple(ia.shape) + (meta.n_skus,))
    d = torch.where(picks, _digits(ia, meta, pows), _digits(ib, meta, pows))
    either_reuse = (ia >= meta.n_arch) | (ib >= meta.n_arch)
    return torch.where(either_reuse, ia, _compose(d, pows))


def _mutate_vec(key, i, meta: EncoderMeta, pows, jump_prob: float):
    """Random neighbor in index space, mirroring ``DesignSpace.mutate``:
    occasionally jump anywhere; reuse candidates hop within the reuse
    family (p=0.7) or back to the arch family; arch candidates hop into
    the reuse family (p=0.15) or tweak one SKU's digit."""
    n = i.shape[0]
    a, r, s = meta.n_arch_choices, meta.n_reuse_choices, meta.n_skus
    (k_jump, k_jto, k_rbranch, k_abranch, k_hop, k_back, k_sku, k_delta,
     k_rto) = prng.split(key, 9).unbind(0)

    is_reuse = i >= meta.n_arch
    # -- reuse family: hop to a different reuse choice or leave ------------
    if r > 1:
        ri = torch.clamp(i - meta.n_arch, 0, r - 1)
        r2 = (ri + 1 + prng.randint(k_hop, (n,), 0, r - 1)) % r
        back = prng.randint(k_back, (n,), 0, meta.n_arch)
        reuse_next = torch.where(prng.uniform(k_rbranch, (n,)) < 0.7,
                                 meta.n_arch + r2, back)
    else:
        reuse_next = prng.randint(k_back, (n,), 0, meta.n_arch)

    # -- arch family: hop into reuse or tweak one SKU digit ----------------
    d = _digits(i, meta, pows)
    sku = prng.randint(k_sku, (n,), 0, s).long()
    delta = prng.randint(k_delta, (n,), 1, max(a, 2))
    row = torch.arange(n, device=i.device)
    d2 = d.clone()
    d2[row, sku] = (d[row, sku] + delta) % a
    arch_next = _compose(d2, pows)
    if r > 0:
        to_reuse = meta.n_arch + prng.randint(k_rto, (n,), 0, r)
        arch_next = torch.where(prng.uniform(k_abranch, (n,)) < 0.15,
                                to_reuse, arch_next)

    out = torch.where(is_reuse, reuse_next, arch_next)
    jump = prng.uniform(k_jump, (n,)) < jump_prob
    return torch.where(jump, prng.randint(k_jto, (n,), 0, meta.size),
                       out).to(torch.int32)


# ---------------------------------------------------------------------------
# The generation step: price -> rank -> breed, on the device
# ---------------------------------------------------------------------------


def _gen_step_impl(tables, key, pop, qty, mc_key, sig, *, meta: EncoderMeta,
                   flow: str, population: int, elite: int,
                   jump_prob: float, n_draws: int, quantile: float):
    # the same fused decode->price composition the evaluator chunks use,
    # so the step's objective and the final ranking sweep agree exactly
    batch, _, nre_tot, total = _fused_totals(tables, pop, meta=meta,
                                             flow=flow)
    if n_draws:
        pf_draws = _fused_risk_draws(batch, nre_tot, qty, mc_key, sig,
                                     flow, n_draws, meta.n_skus)
        obj = portfolio_risk_stats(pf_draws, (quantile,))[
            f"q{int(round(quantile * 100))}"]
    else:
        obj = portfolio_totals(total, qty)

    # deterministic ranking: objective, position-stable on exact ties, as
    # the reference's lax.top_k keeps them (torch.topk promises no order)
    order = torch.sort(obj, stable=True).indices[:elite]
    elite_idx = pop[order]
    elite_obj = obj[order]

    n_child = population - elite
    pows = tables["digit_pow"]      # the encoder's mixed-radix layout
    kpa, kpb, kx, kmut, kgate = prng.split(key, 5).unbind(0)
    pa = elite_idx[prng.randint(kpa, (n_child,), 0, elite).long()]
    pb = elite_idx[prng.randint(kpb, (n_child,), 0, elite).long()]
    child = _crossover_vec(kx, pa, pb, meta, pows)
    mutated = _mutate_vec(kmut, child, meta, pows, jump_prob)
    child = torch.where(prng.bernoulli(kgate, 0.8, (n_child,)), mutated,
                        child)
    next_pop = torch.cat([elite_idx, child])
    return pop, next_pop, elite_idx[0], elite_obj[0]


# The one module-level probe of the generation step: portfolio_search and
# the pricing service's search lane call it alike (see
# repro_torch.obs.torchhooks).
_GEN_STEP_PROBE = torchhooks.instrument(_gen_step_impl, "search.gen_step")


def _read_generation(pop, gen_idx, gen_obj):
    """The priced population and the generation's best index and
    objective in one device-to-host copy (the objective rides as its
    float32 bits)."""
    packed = torchhooks.to_host(torch.cat(
        [pop, gen_idx[None].to(torch.int32),
         gen_obj[None].view(torch.int32)]))
    return packed[:-2], int(packed[-2]), \
        float(packed[-1:].view(np.float32)[0])


def portfolio_search(space: DesignSpace, key, *,
                     population: int = 32, generations: int = 12,
                     elite: int = 6, jump_prob: float = 0.15,
                     risk: Optional[RiskConfig] = None,
                     evaluator: Optional[ChunkedEvaluator] = None,
                     flow: str = "chip-last",
                     checkpoint_dir=None, checkpoint_every: int = 1,
                     checkpoint_keep: int = 3,
                     resume: bool = True, device=None) -> SearchResult:
    """Evolutionary portfolio search, deterministic in ``key``.

    ``key`` is a :mod:`repro_torch.random` key (a JAX ``uint32[2]`` key
    is taken too).  ``risk=RiskConfig(...)`` switches the objective from
    nominal portfolio cost to the configured Monte Carlo quantile (common
    random numbers across all candidates, derived from ``key``).

    Every generation is one step on the device (decode + price + rank +
    breed) and one read back.  The search runs on the evaluator's device,
    else on ``device`` (the GPU unless the caller names another).

    ``checkpoint_dir`` makes the run crash-safe: every
    ``checkpoint_every`` completed generations the loop state
    (:class:`SearchState`) is published atomically (retention
    ``checkpoint_keep``), and — with ``resume=True`` — a rerun pointed
    at the same directory continues from the newest readable step and
    returns a copy of the uninterrupted run's result.
    """
    if elite < 1 or elite > population:
        raise ValueError("need 1 <= elite <= population")
    ev = _check_evaluator(space, flow, evaluator) if evaluator \
        else ChunkedEvaluator(space, candidates_per_chunk=min(population, 64),
                              flow=flow, device=device)
    dev = ev.device if evaluator is not None else resolve_device(device)
    key = prng.as_key(key, dev)
    enc = space.encoder()
    tables = enc.tables_on(dev)
    qty = torch.tensor([sk.quantity for sk in space.skus],
                       dtype=torch.float32, device=dev)
    obj = "cost"
    ev_kw: Dict = {}
    n_draws, quantile = 0, 0.5
    if risk is not None:
        obj = risk.objective_key
        n_draws, quantile = int(risk.n_draws), float(risk.quantile)
        ev_kw = _mc_kwargs(risk, _default_mc_key(key))

    state = SearchState.init(key, population, space.size(), risk)
    manager = None
    if checkpoint_dir is not None:
        manager = CheckpointManager(checkpoint_dir, keep=checkpoint_keep)
        if resume:
            restored = SearchState.restore_latest(manager, population, dev)
            if restored is not None:
                state = restored
    label_fn = lambda i: space.candidate_at(i).label()  # noqa: E731
    for gen in range(state.gen, generations):
        with _TRACER.span("generation", gen=gen):
            state.k_loop, k_gen = prng.split(state.k_loop).unbind(0)
            pop_out, pop_next, gen_idx, gen_obj = _GEN_STEP_PROBE(
                tables, k_gen, state.pop, qty, state.mc_key, state.sig,
                meta=enc.meta, flow=flow, population=population,
                elite=elite, jump_prob=float(jump_prob), n_draws=n_draws,
                quantile=quantile)
            # one host sync per generation: priced population + gen best
            host = _read_generation(pop_out, gen_idx, gen_obj)
        state.consume(host, label_fn)
        state.pop = pop_next
        if manager is not None and checkpoint_every > 0 \
                and state.gen % checkpoint_every == 0 \
                and state.gen < generations:
            state.save(manager)

    # materialize every distinct priced candidate through the fused
    # evaluator (same engine graph => identical objectives), rank on host
    uniq = np.asarray(sorted(state.seen), np.int64)
    if ev.fused:
        arrays = ev.evaluate_indices(uniq, **ev_kw)
        results = ev.results_from_arrays(arrays)
    else:
        results = ev.evaluate([space.candidate_at(int(i)) for i in uniq],
                              **ev_kw)
    ranked = _rank(results, obj)
    return SearchResult(best=ranked[0], ranked=ranked,
                        pareto=_front(ranked, obj), history=state.history,
                        n_evaluated=len(results), objective_key=obj)
