"""Durable admission journal for crash-safe serving.

The counterpart of ``repro.service.durability``, with the same wire
codec and journal format: a journal written by either package replays
in the other.  The tick loop survives faults *inside* the process; this
module makes admitted work survive the process itself.

Three pieces:

* **Wire codec** — :func:`request_to_wire` / :func:`request_from_wire`
  turn every typed request kind into a JSON-safe dict and back.
  ``Candidate`` objects are resolved to space indices at encode time, so
  a journal record never depends on pickling; a decoded request prices
  identically to the original (same indices, same seeds, same sigmas).
* **:class:`RequestJournal`** — an append-only, fsync-batched,
  segment-rotated write-ahead log of admitted requests.  One JSON record
  per line with a CRC32 field; every append is ``flush()``-ed to the OS
  (SIGKILL-safe) and batches of ``fsync_every`` appends are ``fsync``-ed
  (power-loss exposure is bounded).  A torn trailing record (crash mid
  ``write``) is detected and ignored on scan, never raised through.
  Segments rotate at ``segment_max_records`` records; rotation
  carries every still-open admit record forward into the fresh segment
  (fsync-ed before anything is dropped) and then garbage-collects ALL
  older segments — the journal's steady-state size is proportional to
  *open* work, not traffic history, and no kept segment ever depends on
  a record in a dropped one.
* **Replay** — :meth:`RequestJournal.replay` returns every admitted
  request without a terminal record, in admission order, as
  :class:`JournalEntry` rows carrying the request's stable ``origin``
  id.  ``PricingService.start()`` re-admits them with explicit
  ``replayed`` provenance on the responses (see README "Durability &
  restart").

The journal is deliberately service-agnostic below the codec: records
are ``(uid, wire-dict)`` pairs, terminality is a status string, and the
``stats_hook`` lets the owner mirror journal counters into its metrics
registry (the service wires :class:`~repro_torch.service.metrics.
DurabilityStats` in).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import os
import zlib
from typing import Any, Callable, Dict, List, Optional

from ..dse.search import RiskConfig
from ..dse.uncertainty import Uncertainty
from .protocol import (McSpec, MCRiskRequest, PriceRequest,
                       PriceSystemsRequest, RankRequest, Request,
                       SearchRequest, WhatIfRequest)

_SEGMENT_PREFIX = "journal_"
_SEGMENT_SUFFIX = ".log"
_WIRE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class DurabilityConfig:
    """Where and how the service persists admitted work.

    ``directory`` holds the request journal segments plus one
    ``checkpoints/search_<origin>/`` tree per in-flight search.  The
    fsync batch and segment sizes trade write amplification against
    power-loss exposure; process kills (SIGKILL) lose nothing regardless
    because every append reaches the OS page cache before admission is
    acknowledged."""

    directory: pathlib.Path
    fsync_every: int = 8               # appends per fsync batch
    segment_max_records: int = 4096    # records per journal segment
    checkpoint_every: int = 4          # generations between search snaps
    checkpoint_keep: int = 3           # retained checkpoint steps

    def __post_init__(self):
        object.__setattr__(self, "directory",
                           pathlib.Path(self.directory))

    @property
    def journal_dir(self) -> pathlib.Path:
        return self.directory / "journal"

    def checkpoint_dir(self, origin: int) -> pathlib.Path:
        return self.directory / "checkpoints" / f"search_{origin:08d}"


# ---------------------------------------------------------------------------
# Request wire codec
# ---------------------------------------------------------------------------


def _wire_mc(mc: Optional[McSpec]) -> Optional[Dict]:
    if mc is None:
        return None
    return {"draws": int(mc.draws),
            "quantiles": [float(q) for q in mc.quantiles],
            "seed": int(mc.seed),
            "sigmas": _wire_sigmas(mc.sigmas)}


def _wire_sigmas(u: Uncertainty) -> List[float]:
    return [float(u.defect_sigma), float(u.wafer_cost_sigma),
            float(u.bond_sigma), float(u.interposer_sigma)]


def _unwire_sigmas(xs) -> Uncertainty:
    d, w, b, i = (float(x) for x in xs)
    return Uncertainty(defect_sigma=d, wafer_cost_sigma=w, bond_sigma=b,
                       interposer_sigma=i)


def _unwire_mc(d: Optional[Dict]) -> Optional[McSpec]:
    if d is None:
        return None
    return McSpec(draws=int(d["draws"]),
                  quantiles=tuple(float(q) for q in d["quantiles"]),
                  seed=int(d["seed"]), sigmas=_unwire_sigmas(d["sigmas"]))


def _wire_risk(r: Optional[RiskConfig]) -> Optional[Dict]:
    if r is None:
        return None
    return {"n_draws": int(r.n_draws), "quantile": float(r.quantile),
            "sigmas": _wire_sigmas(r.sigmas)}


def _unwire_risk(d: Optional[Dict]) -> Optional[RiskConfig]:
    if d is None:
        return None
    return RiskConfig(n_draws=int(d["n_draws"]),
                      quantile=float(d["quantile"]),
                      sigmas=_unwire_sigmas(d["sigmas"]))


def _indices(req, space) -> Optional[List[int]]:
    """Resolve a request's candidate selection to plain index lists.
    ``None`` stays ``None`` (rank-the-whole-space)."""
    if getattr(req, "candidates", ()) and req.indices is None:
        if space is None:
            raise ValueError(
                "journaling Candidate objects needs the DesignSpace")
        return [int(space.index_of(c)) for c in req.candidates]
    if req.indices is None:
        return None
    return [int(i) for i in req.indices]


def request_to_wire(req: Request, space=None) -> Dict:
    """One typed request -> a JSON-safe dict (inverse:
    :func:`request_from_wire`).  ``Candidate`` objects are resolved to
    indices through ``space`` so the wire form is self-contained."""
    kind = getattr(req, "kind", None)
    d: Dict[str, Any] = {"v": _WIRE_VERSION, "kind": kind,
                         "flow": req.flow}
    deadline = getattr(req, "deadline_ms", None)
    if deadline is not None:
        d["deadline_ms"] = float(deadline)
    if kind in ("price", "rank", "mc_risk"):
        d["indices"] = _indices(req, space)
        d["mc"] = _wire_mc(req.mc)
        if kind == "rank":
            d["top_k"] = int(req.top_k)
            d["objective"] = req.objective
    elif kind == "what_if":
        base = req.base
        if not isinstance(base, int):
            if space is None:
                raise ValueError(
                    "journaling a Candidate base needs the DesignSpace")
            base = int(space.index_of(base))
        d["base"] = int(base)
        d["processes"] = list(req.processes)
        d["integrations"] = list(req.integrations)
    elif kind == "search":
        d.update(seed=int(req.seed), population=int(req.population),
                 generations=int(req.generations), elite=int(req.elite),
                 jump_prob=float(req.jump_prob),
                 risk=_wire_risk(req.risk))
    elif kind == "price_systems":
        d["specs"] = [dict(s) for s in req.specs]
    else:
        raise ValueError(f"unknown request kind {kind!r}")
    return d


def request_from_wire(d: Dict) -> Request:
    """Inverse of :func:`request_to_wire`."""
    kind = d.get("kind")
    deadline = d.get("deadline_ms")
    if kind == "price":
        return PriceRequest(indices=d["indices"], flow=d["flow"],
                            mc=_unwire_mc(d.get("mc")),
                            deadline_ms=deadline)
    if kind == "rank":
        return RankRequest(indices=d["indices"], top_k=int(d["top_k"]),
                           flow=d["flow"], mc=_unwire_mc(d.get("mc")),
                           objective=d["objective"], deadline_ms=deadline)
    if kind == "mc_risk":
        return MCRiskRequest(indices=d["indices"],
                             mc=_unwire_mc(d["mc"]), flow=d["flow"],
                             deadline_ms=deadline)
    if kind == "what_if":
        return WhatIfRequest(base=int(d["base"]),
                             processes=tuple(d["processes"]),
                             integrations=tuple(d["integrations"]),
                             flow=d["flow"], deadline_ms=deadline)
    if kind == "search":
        return SearchRequest(seed=int(d["seed"]),
                             population=int(d["population"]),
                             generations=int(d["generations"]),
                             elite=int(d["elite"]),
                             jump_prob=float(d["jump_prob"]),
                             risk=_unwire_risk(d.get("risk")),
                             flow=d["flow"], deadline_ms=deadline)
    if kind == "price_systems":
        return PriceSystemsRequest(specs=tuple(dict(s)
                                               for s in d["specs"]),
                                   flow=d["flow"], deadline_ms=deadline)
    raise ValueError(f"unknown wire request kind {kind!r}")


# ---------------------------------------------------------------------------
# The journal
# ---------------------------------------------------------------------------


def _crc(payload: Dict) -> int:
    return zlib.crc32(
        json.dumps(payload, sort_keys=True, default=float).encode())


@dataclasses.dataclass
class JournalEntry:
    """One admitted-but-unfinished request, ready for replay."""

    uid: int                       # uid the request was admitted under
    origin: int                    # stable id across replay chains
    request: Request
    wire: Dict
    trace_id: str = ""             # durable trace id (stable across replay)


class RequestJournal:
    """Append-only, fsync-batched, segment-rotated admission WAL
    (see module docstring).

    Record grammar (one JSON object per line, ``crc`` = CRC32 of the
    record without its ``crc`` field)::

        {"rec": "meta",  "seq": n, "fingerprint": ..., "crc": ...}
        {"rec": "admit", "seq": n, "uid": u, "origin": o,
         "trace": t, "req": <wire>, "crc": ...}
        {"rec": "done",  "seq": n, "uid": u, "status": "ok"|<code>,
         "crc": ...}

    ``status`` is ``"ok"``, a typed error code, ``"cancelled"``, or
    ``"replayed"`` (the request was re-admitted under a new uid whose
    admit record precedes this terminal — so a crash between the two
    can only *duplicate* work, never lose it).
    """

    def __init__(self, directory, fsync_every: int = 8,
                 segment_max_records: int = 4096,
                 fingerprint: str = "",
                 stats_hook: Optional[Callable[[str, int], None]] = None):
        self.directory = pathlib.Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.fsync_every = max(1, int(fsync_every))
        self.segment_max_records = max(2, int(segment_max_records))
        self.fingerprint = fingerprint
        self._hook = stats_hook
        # live index, rebuilt by scan(): open admits + per-segment uids
        self._open: "Dict[int, Dict]" = {}      # uid -> admit record
        self._terminal: set = set()             # uids with a done record
        self._segment_uids: Dict[int, set] = {}  # seg no -> admitted uids
        self.max_uid = 0
        self.seq = 0
        self.torn_records = 0
        self.appends = 0
        self.fsyncs = 0
        self.rotations = 0
        self._pending_sync = 0
        self._fh = None
        self._segment_no = 0
        self._segment_records = 0
        self._rotating = False
        self._scan()
        self._open_segment(new=True)

    # -- scan / replay -------------------------------------------------------

    def _segments(self) -> List[int]:
        out = []
        for p in self.directory.iterdir():
            name = p.name
            if name.startswith(_SEGMENT_PREFIX) \
                    and name.endswith(_SEGMENT_SUFFIX):
                out.append(int(name[len(_SEGMENT_PREFIX):
                                    -len(_SEGMENT_SUFFIX)]))
        return sorted(out)

    def _segment_path(self, no: int) -> pathlib.Path:
        return self.directory / \
            f"{_SEGMENT_PREFIX}{no:08d}{_SEGMENT_SUFFIX}"

    def _scan(self):
        """Rebuild the open-request index from every on-disk segment.
        A line that fails to parse or fails its CRC is a torn write:
        counted, skipped, never raised."""
        for no in self._segments():
            uids = self._segment_uids.setdefault(no, set())
            for line in self._segment_path(no).read_text().splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    crc = rec.pop("crc")
                    if crc != _crc(rec):
                        raise ValueError("crc mismatch")
                except (ValueError, KeyError, TypeError):
                    self.torn_records += 1
                    continue
                self.seq = max(self.seq, int(rec.get("seq", 0)))
                kind = rec.get("rec")
                if kind == "admit":
                    uid = int(rec["uid"])
                    self.max_uid = max(self.max_uid, uid)
                    uids.add(uid)
                    self._open[uid] = rec
                elif kind == "done":
                    uid = int(rec["uid"])
                    self._terminal.add(uid)
                    self._open.pop(uid, None)
            self._segment_no = max(self._segment_no, no)

    def replay(self) -> List[JournalEntry]:
        """Every admitted request without a terminal record, oldest
        first.  Undecodable wire payloads are skipped and counted as
        torn (a corrupt record must not poison the whole recovery)."""
        out = []
        for rec in sorted(self._open.values(),
                          key=lambda r: int(r["seq"])):
            try:
                req = request_from_wire(rec["req"])
            except (ValueError, KeyError, TypeError):
                self.torn_records += 1
                continue
            uid = int(rec["uid"])
            out.append(JournalEntry(uid=uid,
                                    origin=int(rec.get("origin", uid)),
                                    request=req, wire=rec["req"],
                                    trace_id=str(rec.get("trace", ""))))
        return out

    @property
    def open_count(self) -> int:
        return len(self._open)

    # -- append path ---------------------------------------------------------

    def _open_segment(self, new: bool):
        if new:
            self._segment_no += 1
            self._segment_records = 0
            self._segment_uids.setdefault(self._segment_no, set())
        path = self._segment_path(self._segment_no)
        self._fh = open(path, "a", encoding="utf-8")
        if new and self.fingerprint:
            self._write({"rec": "meta", "fingerprint": self.fingerprint})

    def _bump(self, name: str, n: int = 1):
        if self._hook is not None:
            self._hook(name, n)

    def _write(self, payload: Dict):
        self.seq += 1
        payload = {"seq": self.seq, **payload}
        payload["crc"] = _crc({k: v for k, v in payload.items()
                               if k != "crc"})
        self._fh.write(json.dumps(payload, default=float) + "\n")
        # flush to the OS on every record: admission acknowledged =>
        # SIGKILL-safe.  fsync (power-loss durability) is batched.
        self._fh.flush()
        self.appends += 1
        self._bump("journal_appends")
        self._pending_sync += 1
        if self._pending_sync >= self.fsync_every:
            self.sync()
        self._segment_records += 1
        if self._segment_records >= self.segment_max_records \
                and not self._rotating:
            self._rotate()

    def sync(self):
        if self._fh is None or self._pending_sync == 0:
            return
        os.fsync(self._fh.fileno())
        self.fsyncs += 1
        self._bump("journal_fsyncs")
        self._pending_sync = 0

    def _rotate(self):
        """Close the full segment, carry every still-open admit forward
        into a fresh one, then drop all older segments.

        Carry-forward is what makes the aggressive GC sound: after it,
        no kept segment's open admit (nor any done record that matters)
        lives in a dropped segment — dropping a closed segment can
        orphan ``done`` records only for admits dropped with it, which
        the scan ignores harmlessly.  The carried copies are fsync-ed
        BEFORE the originals are unlinked, so a crash anywhere in
        rotation can at worst duplicate admit records (the scan
        de-duplicates by uid), never lose one.  If open work exceeds
        ``segment_max_records`` the new segment simply runs oversized
        until some of it terminates."""
        self.sync()
        self._fh.close()
        self.rotations += 1
        self._bump("journal_rotations")
        carried = sorted(self._open.values(), key=lambda r: int(r["seq"]))
        self._open_segment(new=True)
        self._rotating = True
        try:
            for rec in carried:
                self.admit(int(rec["uid"]), rec["req"],
                           origin=int(rec.get("origin", rec["uid"])),
                           trace_id=str(rec.get("trace", "")))
        finally:
            self._rotating = False
        self.sync()
        self._gc()

    def _gc(self):
        """Drop every closed segment (rotation just carried all open
        admits into the current one)."""
        for no in self._segments():
            if no == self._segment_no:
                continue
            self._segment_path(no).unlink(missing_ok=True)
            uids = self._segment_uids.pop(no, set())
            self._terminal -= uids

    # -- the service-facing API ---------------------------------------------

    def admit(self, uid: int, wire: Dict, origin: Optional[int] = None,
              trace_id: str = ""):
        """Journal one admission (the WAL write that makes the request
        crash-safe).  Must be called before the admission is
        acknowledged to the client.  ``trace_id`` rides the record so a
        replay after a crash reconstructs the SAME request trace."""
        uid = int(uid)
        rec = {"rec": "admit", "uid": uid,
               "origin": int(origin if origin is not None else uid),
               "trace": str(trace_id),
               "req": wire}
        self._open[uid] = {**rec, "seq": self.seq + 1}
        self._segment_uids[self._segment_no].add(uid)
        self.max_uid = max(self.max_uid, uid)
        self._write(rec)

    def done(self, uid: int, status: str):
        """Journal a terminal outcome (``ok`` / typed error code /
        ``cancelled`` / ``replayed``): the request will not be replayed."""
        uid = int(uid)
        if uid not in self._open:
            return
        self._open.pop(uid, None)
        self._terminal.add(uid)
        self._write({"rec": "done", "uid": uid, "status": str(status)})

    def close(self):
        if self._fh is not None:
            self.sync()
            self._fh.close()
            self._fh = None

    def stats(self) -> Dict[str, int]:
        return {"segments": len(self._segments()),
                "open": self.open_count,
                "appends": self.appends,
                "fsyncs": self.fsyncs,
                "rotations": self.rotations,
                "torn_records": self.torn_records,
                "max_uid": self.max_uid}
