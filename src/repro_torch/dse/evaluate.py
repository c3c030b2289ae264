"""Fused, fixed-shape batched candidate pricing (repro_torch.dse).

The counterpart of ``repro.dse.evaluate``.  The hot path is
**index-native and on the device**: a chunk of candidate *indices* is
decoded by :func:`~repro_torch.dse.space.encode_arrays` into a padded,
NRE-grouped :class:`~repro_torch.core.batch.SystemBatch` on the device,
priced by the engine's RE implementation and the encoder's closed-form
NRE, reduced to per-candidate portfolio costs (and, optionally,
Monte-Carlo risk quantiles) there, and shipped to the host with exactly
one device-to-host copy per sweep: every chunk is queued without a
sync (:meth:`ChunkedEvaluator.dispatch_indices`), and the sweep's packed
results cross in one ``.cpu()``.

The host-packing path (``candidate_systems`` +
``SystemBatch.from_systems`` + :func:`~repro_torch.core.batch.pad_batch`
priced by :class:`~repro_torch.core.engine.CostEngine`) is kept behind
``fused=False`` as the parity oracle; both paths produce chunks of the
same shapes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import random as prng
from .. import resolve_device, upload
from ..core.batch import SystemBatch, pad_batch
from ..core.engine import CostEngine, _re_impl, finite_rows, portfolio_totals
from ..obs import torchhooks
from ..obs.trace import TRACER as _TRACER
from .space import (Candidate, DesignSpace, EncoderMeta, candidate_systems,
                    encode_arrays, encoded_nre)
from .uncertainty import (Uncertainty, mc_re_totals_impl, mc_totals,
                          portfolio_draws, portfolio_risk_stats)


@dataclasses.dataclass(frozen=True)
class ChunkShape:
    """Worst-case array signature of one evaluation chunk."""

    candidates: int
    n_systems: int
    max_chips: int
    chip_entities: int
    pkg_entities: int
    mod_entities: int
    mod_instances: int
    d2d_entities: int
    d2d_instances: int

    def pad_kwargs(self) -> Dict[str, int]:
        d = dataclasses.asdict(self)
        d.pop("candidates")
        return d


def chunk_shape(space: DesignSpace, candidates_per_chunk: int) -> ChunkShape:
    """Upper-bound shapes for any ``candidates_per_chunk`` candidates.

    Per candidate: S systems (one per SKU), each at most ``max_chips``
    chips; each chip carries one functional module and at most one D2D
    module instance; chip/module design entities are bounded by the chip
    instances, package entities by S, D2D entities by the process menu.
    Entity tables get one slack row so padded instances always have a
    zero-NRE row to point at.  The vectorized encoder emits exactly this
    signature, so fused and host-packed chunks have the same shapes.
    """
    k = int(candidates_per_chunk)
    s = len(space.skus)
    c = space.max_chips()
    per_cand_chips = s * c
    return ChunkShape(
        candidates=k,
        n_systems=k * s,
        max_chips=c,
        chip_entities=k * per_cand_chips + 1,
        pkg_entities=k * s + 1,
        mod_entities=k * per_cand_chips + 1,
        mod_instances=k * per_cand_chips,
        d2d_entities=k * len(space.processes) + 1,
        d2d_instances=k * per_cand_chips,
    )


# ---------------------------------------------------------------------------
# The fused chunk: decode -> price -> portfolio-reduce (-> risk)
# ---------------------------------------------------------------------------


def _fused_totals(tables, idx, *, meta: EncoderMeta, flow: str):
    """Decode + price one chunk: RE via the engine implementation, NRE via
    the layout's closed forms (no scatters) — (batch, re, nre, total),
    the last three (N,).

    The ONE composition of the fused objective: both the evaluator chunks
    and the search generation step price through this function (and
    :func:`_fused_risk_draws` for the Monte-Carlo tail), so their
    objectives are identical by construction.
    """
    batch = encode_arrays(tables, meta, idx)
    re_tot = _re_impl(batch, flow).total
    nre_tot = encoded_nre(tables, meta, idx).total
    return batch, re_tot, nre_tot, re_tot + nre_tot


def _fused_risk_draws(batch, nre_tot, qty, mc_key, sig, flow: str,
                      n_draws: int, n_skus: int):
    """(draws, K) Monte-Carlo portfolio costs for a priced fused chunk:
    RE-only scenario draws plus the once-per-batch NRE row (no perturbed
    parameter enters the NRE model)."""
    draws = mc_re_totals_impl(batch, mc_key, sig, flow, n_draws) \
        + nre_tot[None, :]                                   # (draws, K*S)
    return portfolio_draws(draws, qty, n_skus)


def _chunk_impl(tables, idx, qty, *, meta: EncoderMeta, flow: str):
    _, re_tot, nre_tot, total = _fused_totals(tables, idx, meta=meta,
                                              flow=flow)
    k, s = idx.shape[0], meta.n_skus
    unit = total.reshape(k, s)
    pf = portfolio_totals(unit, qty)
    # trailing element: (K,) numerical guardrail — True where every
    # per-row output is finite (see engine.finite_rows)
    return (unit, re_tot.reshape(k, s), nre_tot.reshape(k, s), pf, None,
            finite_rows(unit, pf))


def _chunk_mc_impl(tables, idx, qty, key, sig, *, meta: EncoderMeta,
                   flow: str, n_draws: int, quantiles: Tuple[float, ...]):
    batch, re_tot, nre_tot, total = _fused_totals(tables, idx, meta=meta,
                                                  flow=flow)
    k, s = idx.shape[0], meta.n_skus
    unit = total.reshape(k, s)
    pf_draws = _fused_risk_draws(batch, nre_tot, qty, key, sig, flow,
                                 n_draws, s)                 # (draws, K)
    risk = portfolio_risk_stats(pf_draws, quantiles)
    pf = portfolio_totals(unit, qty)
    return (unit, re_tot.reshape(k, s), nre_tot.reshape(k, s), pf, risk,
            finite_rows(unit, pf, *risk.values()))


# Module-level probes: the direct APIs and the pricing service call these
# same functions (that sharing is what makes service responses bit-exact
# against the direct calls); each counts its first call of an argument
# signature and, while tracing is on, times every call (see
# repro_torch.obs.torchhooks).
_CHUNK_PROBE = torchhooks.instrument(_chunk_impl, "dse.chunk")
_CHUNK_MC_PROBE = torchhooks.instrument(_chunk_mc_impl, "dse.chunk_mc")


def pack_rows(out) -> Tuple[torch.Tensor, Tuple[str, ...]]:
    """One chunk's outputs as ``(K, 3S + 2 + R)`` float32 rows (unit, RE,
    NRE, portfolio cost, R risk stats, finite) and the risk keys — the
    layout :func:`unpack_rows` reads after the one copy back."""
    unit, re_t, nre_t, pf, risk, finite = out
    risk = risk or {}
    cols = [unit, re_t, nre_t, pf[:, None]]
    cols += [v[:, None] for v in risk.values()]
    cols.append(finite.to(torch.float32)[:, None])
    return torch.cat(cols, dim=1), tuple(risk)


def unpack_rows(host: np.ndarray, n_skus: int,
                risk_keys: Tuple[str, ...]) -> Tuple:
    """Host views of packed rows: ``(unit, re, nre, pf, risk, finite)``
    with ``risk`` a dict keyed as the reference's jitted chunk returns it
    (sorted), or None."""
    s = n_skus
    risk = None
    if risk_keys:
        col = {kk: 3 * s + 1 + i for i, kk in enumerate(risk_keys)}
        risk = {kk: host[:, col[kk]] for kk in sorted(col)}
    return (host[:, :s], host[:, s:2 * s], host[:, 2 * s:3 * s],
            host[:, 3 * s], risk, host[:, -1] > 0.0)


@dataclasses.dataclass
class EvalArrays:
    """Struct-of-arrays result of the fused pipeline: one row per
    candidate index, everything already on the host (single transfer)."""

    idx: np.ndarray               # (K,) candidate indices
    sku_unit_total: np.ndarray    # (K, S) USD per unit, RE + amortized NRE
    sku_unit_re: np.ndarray       # (K, S)
    sku_unit_nre: np.ndarray      # (K, S)
    portfolio_cost: np.ndarray    # (K,) sum_i quantity_i * unit_total_i
    risk: Optional[Dict[str, np.ndarray]] = None   # each (K,)
    finite: Optional[np.ndarray] = None   # (K,) bool; False = NaN/Inf row

    def __len__(self) -> int:
        return self.idx.shape[0]

    def objective(self, key: str = "cost") -> np.ndarray:
        if key == "cost":
            return self.portfolio_cost
        if self.risk is None or key not in self.risk:
            raise KeyError(f"no risk stat {key!r}; evaluate with mc_key set")
        return self.risk[key]


@dataclasses.dataclass
class CandidateResult:
    """Priced candidate: per-SKU unit economics + the portfolio total."""

    candidate: Candidate
    label: str
    sku_names: Sequence[str]
    sku_unit_total: np.ndarray   # (S,) USD per unit, RE + amortized NRE
    sku_unit_re: np.ndarray      # (S,)
    sku_unit_nre: np.ndarray     # (S,)
    portfolio_cost: float        # sum_i quantity_i * unit_total_i, USD
    risk: Optional[Dict[str, float]] = None  # filled by uncertainty pass

    def objective(self, key: str = "cost") -> float:
        """Scalar ranking objective: 'cost' or a risk stat (e.g. 'q90')."""
        if key == "cost":
            return self.portfolio_cost
        if self.risk is None or key not in self.risk:
            raise KeyError(f"no risk stat {key!r} on {self.label}; "
                           "evaluate with mc_key set")
        return self.risk[key]


@dataclasses.dataclass
class PendingSweep:
    """A fused sweep queued on the device and not yet read: the packed
    per-candidate rows ``(K, 3S + 2 + R)`` (unit, RE, NRE, portfolio cost,
    R risk stats, finite) of every index, padding dropped."""

    idx: np.ndarray
    rows: torch.Tensor
    risk_keys: Tuple[str, ...]
    n_skus: int


def _to_host(pending: PendingSweep) -> EvalArrays:
    """The sweep's one device-to-host copy, unpacked into an EvalArrays."""
    unit, re_t, nre_t, pf, risk, finite = unpack_rows(
        torchhooks.to_host(pending.rows), pending.n_skus, pending.risk_keys)
    if risk is not None:
        risk = {kk: v.copy() for kk, v in risk.items()}
    return EvalArrays(idx=pending.idx, sku_unit_total=unit.copy(),
                      sku_unit_re=re_t.copy(), sku_unit_nre=nre_t.copy(),
                      portfolio_cost=pf.copy(), risk=risk, finite=finite)


class ChunkedEvaluator:
    """Prices candidate streams in constant-shape chunks.

    >>> ev = ChunkedEvaluator(space, candidates_per_chunk=64)   # the GPU
    >>> arrays = ev.evaluate_indices(np.arange(10_000))   # fused hot path
    >>> results = ev.evaluate(space.sample(rng, 100))     # object API
    >>> ev.candidates_per_sec

    ``fused=True`` (default) runs the on-device pipeline; ``fused=False``
    keeps the host-packing reference path (same chunk shapes — the
    parity oracle).  Everything prices on ``device``: the GPU unless the
    caller names another (``device="cpu"``); without a GPU the default
    raises.
    """

    def __init__(self, space: DesignSpace, candidates_per_chunk: int = 64,
                 engine: Optional[CostEngine] = None,
                 flow: str = "chip-last", fused: bool = True, device=None):
        self.space = space
        self.device = resolve_device(device)
        self.engine = engine or CostEngine()
        self.flow = flow
        self.fused = bool(fused)
        self.shape = chunk_shape(space, candidates_per_chunk)
        self.encoder = space.encoder() if self.fused else None
        self._qty32 = torch.tensor([sk.quantity for sk in space.skus],
                                   dtype=torch.float32, device=self.device)
        self.reset_stats()

    # -- throughput bookkeeping ---------------------------------------------
    def reset_stats(self):
        self.n_candidates = 0
        self.n_systems = 0
        self.n_chunks = 0
        self.elapsed_s = 0.0

    @property
    def candidates_per_sec(self) -> float:
        return self.n_candidates / max(self.elapsed_s, 1e-12)

    @property
    def systems_per_sec(self) -> float:
        return self.n_systems / max(self.elapsed_s, 1e-12)

    def stats(self) -> Dict[str, float]:
        return {"n_candidates": self.n_candidates,
                "n_systems": self.n_systems, "n_chunks": self.n_chunks,
                "elapsed_s": self.elapsed_s,
                "candidates_per_sec": self.candidates_per_sec,
                "systems_per_sec": self.systems_per_sec}

    def _check_indices(self, idx) -> np.ndarray:
        idx = np.asarray(idx, np.int64)
        if idx.ndim != 1 or idx.size == 0:
            raise ValueError("need a 1-D, non-empty index vector")
        if idx.min() < 0 or idx.max() >= self.space.size():
            raise IndexError("candidate index out of range")
        return idx

    # -- fused index-native path --------------------------------------------
    def dispatch_indices(self, idx, mc_key=None, mc_draws: int = 128,
                         mc_sigmas=None,
                         mc_quantiles: Sequence[float] = (0.5, 0.9),
                         ) -> PendingSweep:
        """Queue the fused pricing of candidate *indices* on the device and
        return without reading anything back (no sync, the uploads of the
        indices and the sigmas included: they leave pinned memory without
        blocking).

        The stream is cut into constant-shape chunks (the final partial
        chunk is padded by repeating its first index; padded rows are
        dropped).  With ``mc_key`` set the same pass also computes
        Monte-Carlo portfolio risk stats under common random numbers (the
        same key for every chunk).
        """
        if not self.fused:
            raise RuntimeError("evaluate_indices requires fused=True")
        idx = self._check_indices(idx)
        k, s = self.shape.candidates, len(self.space.skus)
        last = (-(-idx.size // k) - 1) * k        # the final chunk's start
        padded = np.full((last + k,), idx[last], np.int32)
        padded[:idx.size] = idx
        dev_idx = upload(padded, self.device)
        tables = self.encoder.tables_on(self.device)
        if mc_key is not None:
            key = prng.as_key(mc_key, self.device)
            sig = (mc_sigmas or Uncertainty()).as_array(self.device)
            quantiles = tuple(float(q) for q in mc_quantiles)
        rows, risk_keys = [], ()
        for lo in range(0, padded.size, k):
            with _TRACER.span("chunk", lo=lo):
                chunk = dev_idx[lo:lo + k]
                if mc_key is None:
                    out = _CHUNK_PROBE(tables, chunk, self._qty32,
                                       meta=self.encoder.meta, flow=self.flow)
                else:
                    out = _CHUNK_MC_PROBE(tables, chunk, self._qty32, key,
                                          sig, meta=self.encoder.meta,
                                          flow=self.flow,
                                          n_draws=int(mc_draws),
                                          quantiles=quantiles)
                packed, risk_keys = pack_rows(out)
                rows.append(packed)
        return PendingSweep(idx=idx, rows=torch.cat(rows)[:idx.size],
                            risk_keys=risk_keys, n_skus=s)

    def evaluate_indices(self, idx, mc_key=None, mc_draws: int = 128,
                         mc_sigmas=None,
                         mc_quantiles: Sequence[float] = (0.5, 0.9),
                         ) -> EvalArrays:
        """Price candidate *indices* through the fused on-device pipeline:
        :meth:`dispatch_indices`, then the whole stream's results cross to
        the host in one copy — no per-chunk (let alone per-candidate)
        device-to-host round trips."""
        t0 = time.perf_counter()
        pending = self.dispatch_indices(idx, mc_key=mc_key,
                                        mc_draws=mc_draws,
                                        mc_sigmas=mc_sigmas,
                                        mc_quantiles=mc_quantiles)
        out = _to_host(pending)                 # one sync for the stream
        self.elapsed_s += time.perf_counter() - t0
        n = len(out)
        self.n_candidates += n
        self.n_systems += n * len(self.space.skus)
        self.n_chunks += -(-n // self.shape.candidates)
        return out

    def results_from_arrays(self, arrays: EvalArrays,
                            candidates: Optional[Sequence[Candidate]] = None,
                            ) -> List[CandidateResult]:
        """Materialize host :class:`CandidateResult` objects (labels and
        all) from fused pipeline output — the cold path, meant for
        winners/reports rather than the full stream."""
        if candidates is None:
            candidates = [self.space.candidate_at(int(i))
                          for i in arrays.idx]
        names = [sk.name for sk in self.space.skus]
        out = []
        for j, cand in enumerate(candidates):
            risk = None
            if arrays.risk is not None:
                risk = {kk: float(v[j]) for kk, v in arrays.risk.items()}
            out.append(CandidateResult(
                candidate=cand, label=cand.label(), sku_names=names,
                sku_unit_total=np.asarray(arrays.sku_unit_total[j],
                                          np.float64),
                sku_unit_re=np.asarray(arrays.sku_unit_re[j], np.float64),
                sku_unit_nre=np.asarray(arrays.sku_unit_nre[j], np.float64),
                portfolio_cost=float(arrays.portfolio_cost[j]), risk=risk))
        return out

    # -- object API ----------------------------------------------------------
    def evaluate(self, candidates: Sequence[Candidate],
                 mc_key=None, mc_draws: int = 128, mc_sigmas=None,
                 mc_quantiles: Sequence[float] = (0.5, 0.9),
                 ) -> List[CandidateResult]:
        """Price every candidate; optionally attach Monte Carlo risk stats.

        With ``mc_key`` set, each chunk is additionally priced under
        ``mc_draws`` correlated parameter scenarios (see
        :mod:`repro_torch.dse.uncertainty`) — the *same* key (common
        random numbers) is reused for every chunk so candidates are
        compared under identical scenarios regardless of chunking.

        Candidates that are valid for ``candidate_systems`` but not
        members of this space's menus cannot be index-encoded; such a
        stream goes through the host-packing path.
        """
        candidates = list(candidates)
        if not candidates:
            return []
        if self.fused:
            try:
                idx = np.asarray([self.space.index_of(c)
                                  for c in candidates], np.int64)
            except ValueError:
                idx = None      # foreign-but-priceable candidates
            if idx is not None:
                arrays = self.evaluate_indices(
                    idx, mc_key=mc_key, mc_draws=mc_draws,
                    mc_sigmas=mc_sigmas, mc_quantiles=mc_quantiles)
                return self.results_from_arrays(arrays, candidates)
        return self._evaluate_legacy(candidates, mc_key, mc_draws,
                                     mc_sigmas, mc_quantiles)

    # -- legacy host-packing path (parity oracle) ---------------------------
    def pack_chunk(self, chunk: Sequence[Candidate]) -> SystemBatch:
        """Pack <= candidates_per_chunk candidates into one padded batch
        via the host ``System`` route (reference path)."""
        if len(chunk) > self.shape.candidates:
            raise ValueError(f"chunk of {len(chunk)} exceeds "
                             f"{self.shape.candidates} candidates")
        systems, groups = [], []
        for j, cand in enumerate(chunk):
            grp = candidate_systems(self.space, cand)
            systems += grp
            groups += [j] * len(grp)
        batch = SystemBatch.from_systems(systems, share_nre=groups,
                                         max_chips=self.shape.max_chips,
                                         device=self.device)
        return pad_batch(batch, **self.shape.pad_kwargs())

    def _legacy_chunk_host(self, chunk: Sequence[Candidate], mc_key,
                           mc_draws: int, mc_sigmas) -> Tuple:
        """Price one candidate chunk through the host-packing path.

        Returns float64 host arrays ``(total, re, nre, pf_draws)`` with
        the first three ``(len(chunk) * S,)`` per-system rows and
        ``pf_draws`` a ``(draws, len(chunk))`` portfolio-cost matrix (or
        None without ``mc_key``).  Per-row values are
        chunk-composition-independent (cost-neutral padding; MC draws are
        systematic scalar multipliers), and the engine's NRE sums are the
        same every call, so a rerun gives the same bits.
        """
        s = len(self.space.skus)
        n = len(chunk) * s
        qty = np.asarray([sk.quantity for sk in self.space.skus], np.float64)
        batch = self.pack_chunk(chunk)
        tc = self.engine.total(batch, flow=self.flow)
        dev = [tc.total, tc.re.total, tc.nre.total]
        if mc_key is not None:
            draws = mc_totals(batch, mc_key, n_draws=mc_draws,
                              flow=self.flow, sigmas=mc_sigmas)
            # fold the real (unpadded) rows into per-candidate
            # portfolio costs: (draws, len(chunk))
            dev.append(portfolio_draws(draws[:, :n], qty, s).reshape(-1))
        # every device->host transfer of the chunk in one copy
        host = torchhooks.to_host(torch.cat(
            [d.reshape(-1).to(torch.float32) for d in dev])
        ).astype(np.float64)
        pf_draws = None
        if mc_key is not None:
            pf_draws = host[3 * batch.n_systems:].reshape(-1, len(chunk))
        rows = slice(0, n)
        m = batch.n_systems
        return (host[rows], host[m:m + n], host[2 * m:2 * m + n], pf_draws)

    @staticmethod
    def _legacy_risk(pf_col: np.ndarray,
                     quantiles: Sequence[float]) -> Dict[str, float]:
        """Host risk stats of one candidate's draw column — shared by the
        oracle and the index-native legacy path so the two stay
        bit-identical."""
        risk = {"mean": float(pf_col.mean()), "std": float(pf_col.std())}
        for q in quantiles:
            risk[f"q{int(round(q * 100))}"] = float(np.quantile(pf_col, q))
        return risk

    def _evaluate_legacy(self, candidates, mc_key, mc_draws, mc_sigmas,
                         mc_quantiles) -> List[CandidateResult]:
        s = len(self.space.skus)
        qty = np.asarray([sk.quantity for sk in self.space.skus], np.float64)
        names = [sk.name for sk in self.space.skus]
        out: List[CandidateResult] = []
        k = self.shape.candidates
        for lo in range(0, len(candidates), k):
            chunk = candidates[lo:lo + k]
            t0 = time.perf_counter()
            total, re_tot, nre_tot, pf_draws = self._legacy_chunk_host(
                chunk, mc_key, mc_draws, mc_sigmas)
            self.elapsed_s += time.perf_counter() - t0
            for j, cand in enumerate(chunk):
                rows = slice(j * s, (j + 1) * s)
                unit = total[rows]
                risk = self._legacy_risk(pf_draws[:, j], mc_quantiles) \
                    if pf_draws is not None else None
                out.append(CandidateResult(
                    candidate=cand, label=cand.label(), sku_names=names,
                    sku_unit_total=unit, sku_unit_re=re_tot[rows],
                    sku_unit_nre=nre_tot[rows],
                    portfolio_cost=float((qty * unit).sum()), risk=risk))
            self.n_candidates += len(chunk)
            self.n_systems += len(chunk) * s
            self.n_chunks += 1
        return out

    def evaluate_indices_legacy(self, idx, mc_key=None, mc_draws: int = 128,
                                mc_sigmas=None,
                                mc_quantiles: Sequence[float] = (0.5, 0.9),
                                ) -> EvalArrays:
        """Index-native pricing through the **legacy host-packing path**.

        Same signature and :class:`EvalArrays` contract as
        :meth:`evaluate_indices`, but every chunk goes host ``System``
        packing -> engine -> host, no fused decode: slow (per-candidate
        Python packing) but correct, with results equal to float32 casts
        of the legacy oracle's float64 values by construction (shared
        :meth:`_legacy_chunk_host` / :meth:`_legacy_risk`).  Works with
        ``fused=False`` evaluators too — no encoder needed.
        """
        idx = self._check_indices(idx)
        s = len(self.space.skus)
        qty = np.asarray([sk.quantity for sk in self.space.skus], np.float64)
        quantiles = tuple(float(q) for q in mc_quantiles)
        n, k = idx.size, self.shape.candidates
        unit = np.empty((n, s), np.float32)
        re_a = np.empty((n, s), np.float32)
        nre_a = np.empty((n, s), np.float32)
        pf = np.empty((n,), np.float32)
        risk = None
        if mc_key is not None:
            risk = {kk: np.empty((n,), np.float32)
                    for kk in ("mean", "std")
                    + tuple(f"q{int(round(q * 100))}" for q in quantiles)}
        t0 = time.perf_counter()
        for lo in range(0, n, k):
            with _TRACER.span("legacy_chunk", lo=lo):
                chunk = [self.space.candidate_at(int(i))
                         for i in idx[lo:lo + k]]
                total, re_tot, nre_tot, pf_draws = self._legacy_chunk_host(
                    chunk, mc_key, mc_draws, mc_sigmas)
                for j in range(len(chunk)):
                    rows = slice(j * s, (j + 1) * s)
                    u = total[rows]
                    unit[lo + j] = u
                    re_a[lo + j] = re_tot[rows]
                    nre_a[lo + j] = nre_tot[rows]
                    pf[lo + j] = float((qty * u).sum())
                    if pf_draws is not None:
                        for kk, v in self._legacy_risk(
                                pf_draws[:, j], quantiles).items():
                            risk[kk][lo + j] = v
        self.elapsed_s += time.perf_counter() - t0
        self.n_candidates += n
        self.n_systems += n * s
        self.n_chunks += -(-n // k)
        finite = np.isfinite(unit).all(-1) & np.isfinite(pf)
        if risk is not None:
            for v in risk.values():
                finite &= np.isfinite(v)
        return EvalArrays(idx=idx, sku_unit_total=unit, sku_unit_re=re_a,
                          sku_unit_nre=nre_a, portfolio_cost=pf, risk=risk,
                          finite=finite)


def evaluate_direct(space: DesignSpace, cand: Candidate,
                    engine: Optional[CostEngine] = None,
                    flow: str = "chip-last", device=None) -> CandidateResult:
    """Unchunked, unpadded single-candidate pricing (reference path).

    Builds the candidate's group as its own ``share_nre=True`` batch on
    ``device`` (the GPU unless the caller names another) and prices it
    directly — the cross-check the padded-chunk parity tests compare
    against.
    """
    engine = engine or CostEngine()
    grp = candidate_systems(space, cand)
    tc = engine.total(SystemBatch.from_systems(grp, share_nre=True,
                                               device=device), flow=flow)
    host = torchhooks.to_host(torch.stack([tc.total, tc.re.total,
                                            tc.nre.total]))
    qty = np.asarray([sk.quantity for sk in space.skus], np.float64)
    unit = host[0].astype(np.float64)
    return CandidateResult(
        candidate=cand, label=cand.label(),
        sku_names=[sk.name for sk in space.skus], sku_unit_total=unit,
        sku_unit_re=host[1].astype(np.float64),
        sku_unit_nre=host[2].astype(np.float64),
        portfolio_cost=float((qty * unit).sum()))
