"""Two-level caching for the pricing service (the counterpart of
``repro.service.cache``).

1. **Trace cache** — the warm-signature layer.  Nothing compiles in
   PyTorch, but the first call of a lane's argument signature is the one
   that takes the allocator's first blocks, the libraries' handles and
   the pinned staging buffers.  Every chunk/MC/search/raw signature the
   service is configured to serve runs once at startup (or, for a
   signature first seen at admission time, *at admission*, off the tick
   loop): :class:`TraceCache` tracks which signatures are warm and counts
   any first call of a probe's signature inside a tick as a violation
   the metrics/tests surface.
2. **Result cache** — an LRU over finished answers keyed on
   ``(space fingerprint, flow, mc signature, candidate-index digest)``.
   A repeated sweep (the common interactive pattern: re-rank the same
   shortlist after looking at a report) is served from the host with
   zero device work.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from collections import OrderedDict
from typing import Any, Dict, Hashable, Optional, Tuple

import numpy as np

from ..dse.space import DesignSpace
from ..obs import torchhooks
from ..obs.trace import TRACER


def space_fingerprint(space: DesignSpace) -> str:
    """Stable digest of a space definition — the cache namespace, the
    same digest as the reference's for the same space.

    Two structurally identical spaces (same SKUs/menus/flags) fingerprint
    identically regardless of object identity."""
    payload = {
        "skus": [[s.name, s.module_area_mm2, s.quantity]
                 for s in space.skus],
        "processes": list(space.processes),
        "integrations": list(space.integrations),
        "chiplet_counts": list(space.chiplet_counts),
        "allow_reuse": space.allow_reuse,
        "reuse_package_options": list(space.reuse_package_options),
        "reuse_within_sku": space.reuse_within_sku,
    }
    blob = json.dumps(payload, sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()


def index_digest(idx: np.ndarray) -> str:
    """Digest of a candidate index vector (order-sensitive: the response
    rows are positional)."""
    a = np.ascontiguousarray(np.asarray(idx, np.int64))
    return hashlib.sha1(a.tobytes()).hexdigest()


class LRUCache:
    """Tiny ordered-dict LRU with hit/miss counters."""

    def __init__(self, max_entries: int = 256):
        self.max_entries = int(max_entries)
        self._d: "OrderedDict[Hashable, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._d)

    def get(self, key: Hashable):
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        self.misses += 1
        return None

    def put(self, key: Hashable, value: Any):
        if self.max_entries <= 0:
            return
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.max_entries:
            self._d.popitem(last=False)

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def stats(self) -> Dict[str, float]:
        return {"entries": len(self._d), "hits": self.hits,
                "misses": self.misses, "hit_rate": self.hit_rate}


class ResultCache:
    """LRU of finished :class:`EvalArrays` keyed on
    ``(space fingerprint, flow, mc signature, index digest)``.

    Only index-addressed sweeps are cached (price / mc_risk / rank share
    entries: a rank over cached arrays re-ranks on the host).  Entries
    above ``max_rows`` are not cached — a 1M-candidate sweep should not
    evict the interactive working set."""

    def __init__(self, max_entries: int = 256, max_rows: int = 65536):
        self.lru = LRUCache(max_entries)
        self.max_rows = int(max_rows)

    @staticmethod
    def key(fingerprint: str, flow: str, mc_sig: Optional[Tuple],
            idx: np.ndarray) -> Tuple:
        return (fingerprint, flow, mc_sig, index_digest(idx))

    def get(self, key: Tuple):
        return self.lru.get(key)

    def put(self, key: Tuple, arrays) -> bool:
        if len(arrays) > self.max_rows:
            return False
        self.lru.put(key, arrays)
        return True

    def stats(self) -> Dict[str, float]:
        return self.lru.stats()


@dataclasses.dataclass(frozen=True)
class LaneSignature:
    """The static signature key of one service lane: what must be warm
    before requests of this shape hit the tick loop."""

    kind: str                                 # chunk | mc | gen | raw
    flow: str
    static: Tuple = ()                        # e.g. (draws, quantiles)


class TraceCache:
    """Tracks warmed lane signatures + counts post-warmup first calls.

    The lanes run the module-level probes of
    ``repro_torch.dse.evaluate`` / ``search`` / ``repro_torch.core.engine``,
    shared with the direct APIs — that sharing is what makes service
    responses bit-exact against them.  This class records *which*
    signatures have been warmed and meters the probes' first calls
    (counted whether tracing is on or off) so the metrics can prove no
    lane signature ran for the first time on the tick loop."""

    def __init__(self):
        self.warmed: Dict[LaneSignature, bool] = {}
        self._tick_recompiles = 0

    def is_warm(self, sig: LaneSignature) -> bool:
        return self.warmed.get(sig, False)

    def ensure(self, sig: LaneSignature, compile_fn,
               trace_id: str = "") -> bool:
        """Run ``sig``'s warmup now (admission time) if cold.  Returns
        True if a warmup actually ran.  ``trace_id`` labels the warmup
        span with the request that forced it, so "why was this admission
        slow" is answerable from its trace tree."""
        if self.is_warm(sig):
            return False
        with TRACER.span("admission_compile", kind=sig.kind,
                         flow=sig.flow, trace_id=trace_id):
            compile_fn()
        self.warmed[sig] = True
        return True

    # -- tick-time recompile metering ---------------------------------------
    @staticmethod
    def counts() -> Dict[str, int]:
        return {p.name: p.first_calls for p in torchhooks.probes()}

    def meter_tick(self, before: Dict[str, int]) -> int:
        """Record (and return) the number of first calls made during a
        tick — anything nonzero means a cold request leaked onto the hot
        path."""
        after = self.counts()
        delta = sum(n - before.get(k, 0) for k, n in after.items())
        self._tick_recompiles += delta
        return delta

    @property
    def tick_recompiles(self) -> int:
        return self._tick_recompiles

    def stats(self) -> Dict[str, Any]:
        return {"warmed_signatures": len(self.warmed),
                "tick_recompiles": self._tick_recompiles}
