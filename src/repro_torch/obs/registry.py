"""Named metrics registry: counters / gauges / histograms with JSON and
Prometheus-style text exposition.

A copy of the JAX package's ``obs/registry.py``: every subsystem
registers named instruments against one process-wide :data:`REGISTRY`
and exporters (``svc.snapshot()``, a text scrape) read one coherent
snapshot.

:class:`TraceCounts` is a :class:`collections.Counter` subclass that
mirrors every increment into the registry as a ``trace_<key>`` counter.
"""
from __future__ import annotations

import collections
import json
import math
import threading
import time
from typing import Dict, List, Optional


class Counter:
    """Monotonic counter."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, n: float = 1.0):
        if n < 0:
            raise ValueError("counters only go up")
        self.value += n

    def get(self) -> float:
        return self.value

    def sample(self) -> Dict[str, float]:
        return {"value": self.value}


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)

    def inc(self, n: float = 1.0):
        self.value += n

    def dec(self, n: float = 1.0):
        self.value -= n

    def get(self) -> float:
        return self.value

    def sample(self) -> Dict[str, float]:
        return {"value": self.value}


class Histogram:
    """Streaming distribution: count/sum/min/max plus a bounded sample
    reservoir for quantiles (deterministic decimation, no RNG).

    Observations may carry an *exemplar* — an opaque reference string
    (here: a request ``trace_id``) tying the distribution back to a
    concrete traced request, OpenMetrics-style.  Exemplars live in a
    small bounded deque (latest wins) so the cost is O(1) per observe.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "", max_samples: int = 4096,
                 max_exemplars: int = 8):
        self.name = name
        self.help = help
        self.max_samples = int(max_samples)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._samples: List[float] = []
        self._stride = 1
        self._exemplars: collections.deque = \
            collections.deque(maxlen=int(max_exemplars))

    def observe(self, v: float, exemplar: Optional[str] = None):
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if exemplar:
            self._exemplars.append((str(exemplar), v))
        if (self.count - 1) % self._stride == 0:
            self._samples.append(v)
            if len(self._samples) > self.max_samples:
                # decimate: keep every other sample, double the stride
                self._samples = self._samples[::2]
                self._stride *= 2

    def exemplars(self) -> List[Dict[str, float]]:
        """Recent ``{"ref", "value"}`` exemplar pairs (oldest first)."""
        return [{"ref": r, "value": v} for r, v in self._exemplars]

    def quantile(self, q: float) -> float:
        if not self._samples:
            return 0.0
        xs = sorted(self._samples)
        i = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
        return xs[i]

    def sample(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
        out = {"count": self.count, "sum": self.sum, "min": self.min,
               "max": self.max, "mean": self.sum / self.count,
               "p50": self.quantile(0.50), "p95": self.quantile(0.95),
               "p99": self.quantile(0.99)}
        # Key is present only when exemplars were attached, so snapshots
        # from exemplar-free instruments stay byte-identical.
        if self._exemplars:
            out["exemplars"] = self.exemplars()
        return out


class Registry:
    """Get-or-create instrument store; snapshot + text exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "collections.OrderedDict[str, object]" = \
            collections.OrderedDict()
        self._t0 = time.time()

    def _get_or_create(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  max_samples: int = 4096) -> Histogram:
        return self._get_or_create(Histogram, name, help,
                                   max_samples=max_samples)

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return list(self._metrics)

    def reset(self):
        """Drop every registered instrument (tests / fresh benchmarks)."""
        with self._lock:
            self._metrics.clear()

    # -- exposition ----------------------------------------------------------
    def snapshot(self) -> Dict[str, Dict]:
        """JSON-ready ``{name: {kind, ...samples}}`` of every instrument."""
        out = {}
        for name, m in list(self._metrics.items()):
            row = {"kind": m.kind}
            row.update(m.sample())
            out[name] = row
        return out

    def exposition(self) -> str:
        """Prometheus-style text format (one scrape of the registry)."""
        lines = []
        for name, m in list(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if m.kind == "histogram":
                s = m.sample()
                lines.append(f"{name}_count {s['count']:g}")
                lines.append(f"{name}_sum {s['sum']:g}")
                for q in ("p50", "p95", "p99"):
                    lines.append(
                        f'{name}{{quantile="{q[1:]}"}} {s[q]:g}')
                # OpenMetrics-flavoured exemplars as comment lines so
                # classic Prometheus text parsers skip them cleanly.
                for ex in m.exemplars():
                    lines.append(
                        f'# EXEMPLAR {name}{{trace_id="{ex["ref"]}"}} '
                        f'{ex["value"]:g}')
            else:
                lines.append(f"{name} {m.get():g}")
        return "\n".join(lines) + "\n"

    def write_json(self, path) -> "pathlib.Path":
        import pathlib
        path = pathlib.Path(path)
        path.write_text(json.dumps(self.snapshot(), indent=2,
                                   sort_keys=True, default=float) + "\n")
        return path


# The process-wide registry every instrumented module shares.
REGISTRY = Registry()


class TraceCounts(collections.Counter):
    """Drop-in ``collections.Counter`` whose increments also land in the
    metrics registry as ``trace_<key>`` counters.

    Counts kept in one stay readable as a plain ``Counter`` while the
    same counts are available to scrapes.  Decrements are deliberately
    not mirrored: registry counters are monotonic.
    """

    def __init__(self, registry: Optional[Registry] = None,
                 prefix: str = "trace"):
        super().__init__()
        self._registry = registry if registry is not None else REGISTRY
        self._prefix = prefix

    def __setitem__(self, key, value):
        delta = value - self.get(key, 0)
        super().__setitem__(key, value)
        if delta > 0:
            self._registry.counter(
                f"{self._prefix}_{key}",
                help="trace count",
            ).inc(delta)
