"""Cost attribution of the port's hot entry points: per-signature
first-call/dispatch probes and the one device-to-host copy helper (the
counterpart of ``repro.obs.jaxhooks``).

The stack's hot paths are module-level functions
(``repro_torch.core.engine._total_impl``, ``repro_torch.dse.evaluate``'s
chunk functions, ``repro_torch.dse.search._gen_step_impl``).
:func:`instrument` wraps each of them in a :class:`Probe`.  Nothing
compiles in PyTorch, so a probe's **first call of an argument
signature** (every tensor leaf's shape, dtype and device, and every
static argument) stands where a jit compile stood, and is counted so:
the first call of a signature is the one that takes the allocator's
first blocks and the libraries' handles.  Every later call of the same
signature is a steady-state **dispatch**.

Probes count first calls and dispatches per signature whether tracing is
on or off (one signature walk and one set lookup a call), so the
service's :class:`~repro_torch.service.cache.TraceCache` can meter a
lane signature first run on the tick loop in every run.  With tracing on
they also time each call (host wall: a CUDA call queues its kernels and
returns) into ``jit_compile`` / ``kernel_dispatch`` spans and registry
counters.  :meth:`Probe.forget` drops a probe's seen signatures — the
``recompile`` fault's counterpart of dropping a jit cache.

:func:`to_host` is the one way the service and the evaluator copy
results back: it counts calls, bytes and seconds (the ``device_get``
spans and counters).  No torch function is patched.
"""
from __future__ import annotations

import dataclasses
from time import perf_counter
from typing import Any, Callable, Dict, List, Tuple

import torch

from . import trace
from .registry import REGISTRY


@dataclasses.dataclass
class SignatureStats:
    """Wall attribution of one (probe, argument-signature) pair.
    ``compiles`` counts first calls (every one since the last
    :meth:`Probe.forget`), ``calls`` the calls after them; the seconds
    are measured while tracing is on."""

    compiles: int = 0
    compile_s: float = 0.0
    calls: int = 0
    dispatch_s: float = 0.0

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def signature_of(obj, out: List) -> List:
    """Append ``obj``'s signature to ``out``, walked as the port's pytree
    flattening: a tensor is its shape, dtype and device; a dict its sorted
    keys, then its values; a list or tuple its items; a dataclass its
    fields in order — a class with a ``_LEAVES`` tuple (``SystemBatch``)
    only those, so display metadata such as system names stays out — and
    anything else its type and hash (its ``repr`` when unhashable)."""
    if isinstance(obj, torch.Tensor):
        out.append((obj.shape, obj.dtype, obj.device))
    elif isinstance(obj, dict):
        keys = sorted(obj)
        out.append(tuple(keys))
        for k in keys:
            signature_of(obj[k], out)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            signature_of(x, out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        names = getattr(obj, "_LEAVES", None) or \
            tuple(f.name for f in dataclasses.fields(obj))
        for n in names:
            signature_of(getattr(obj, n), out)
    else:
        try:
            out.append((type(obj).__name__, hash(obj)))
        except TypeError:
            out.append(repr(obj)[:80])
    return out


class Probe:
    """Transparent wrapper over a hot entry point (see module docstring)."""

    def __init__(self, fn: Callable, name: str):
        self.fn = fn
        self.name = name
        self.stats: Dict[Any, SignatureStats] = {}
        self.seen: set = set()
        self.first_calls = 0
        m = self.name.replace(".", "_").replace("-", "_")
        self._counter_names = (f"jit_{m}_compiles", f"jit_{m}_compile_s",
                               f"jit_{m}_calls", f"jit_{m}_dispatch_s")
        _PROBES.append(self)

    def __call__(self, *args, **kwargs):
        traced = trace.TRACER.enabled()
        # the signature walk is inside the timed window on purpose: it is
        # probe-induced dispatch cost and must show up as covered span
        # wall, not as an unattributed hole in the tick.
        t0 = perf_counter() if traced else 0.0
        sig = self.signature(args, kwargs)
        first = sig not in self.seen
        st = self.stats.get(sig)
        if st is None:
            st = self.stats[sig] = SignatureStats()
        if first:
            self.seen.add(sig)
            self.first_calls += 1
            st.compiles += 1
        else:
            st.calls += 1
        out = self.fn(*args, **kwargs)
        if not traced:
            return out
        dt = perf_counter() - t0
        n_compiles, n_compile_s, n_calls, n_dispatch_s = self._counter_names
        if first:
            st.compile_s += dt
            trace.TRACER.add_complete("jit_compile", dt, fn=self.name)
            REGISTRY.counter(n_compiles).inc()
            REGISTRY.counter(n_compile_s).inc(dt)
        else:
            st.dispatch_s += dt
            trace.TRACER.add_complete("kernel_dispatch", dt, fn=self.name)
            REGISTRY.counter(n_calls).inc()
            REGISTRY.counter(n_dispatch_s).inc(dt)
        return out

    @staticmethod
    def signature(args, kwargs) -> Tuple:
        return tuple(signature_of((args, kwargs), []))

    def forget(self):
        """Drop the seen signatures: the next call of each is a first
        call again (the ``recompile`` fault)."""
        self.seen.clear()

    def summary(self) -> Dict[str, float]:
        """Aggregate over signatures: total first calls / walls / calls."""
        out = {"signatures": len(self.stats), "compiles": 0,
               "compile_s": 0.0, "calls": 0, "dispatch_s": 0.0}
        for st in self.stats.values():
            out["compiles"] += st.compiles
            out["compile_s"] += st.compile_s
            out["calls"] += st.calls
            out["dispatch_s"] += st.dispatch_s
        return out

    def reset(self):
        """Clear the stats; the seen signatures stay (a reset is not a
        forget)."""
        self.stats.clear()
        self.first_calls = 0


_PROBES: List[Probe] = []


def instrument(fn: Callable, name: str) -> Probe:
    """Wrap an entry point in a :class:`Probe` (registered for
    :func:`stats` aggregation)."""
    return Probe(fn, name)


def probes() -> List[Probe]:
    return list(_PROBES)


def stats() -> Dict[str, Dict[str, float]]:
    """Per-probe first-call/dispatch attribution (aggregated signatures)."""
    return {p.name: p.summary() for p in _PROBES}


def reset():
    """Clear all probe stats."""
    for p in _PROBES:
        p.reset()


def total_compiles() -> int:
    """First calls of a signature across every probe (tracing on or
    off)."""
    return sum(p.first_calls for p in _PROBES)


def total_dispatch_s() -> float:
    """Total probe-attributed wall (first calls + steady-state dispatch)
    across every probe.  Deltas of this marker give the measured "dispatch
    ms inside this tick" the serving-cost ledger pro-rates per request.
    Only meaningful while tracing is on (probes forward untimed when
    off); callers fall back to tick wall otherwise."""
    total = 0.0
    for p in _PROBES:
        s = p.summary()
        total += s["compile_s"] + s["dispatch_s"]
    return total


def recompiles_since(marker: int) -> int:
    """First calls measured since a ``total_compiles()`` marker — the
    queryable "recompiles after warmup" invariant."""
    return total_compiles() - marker


# ---------------------------------------------------------------------------
# to_host: the counted device->host copy
# ---------------------------------------------------------------------------


def _host(x, nbytes: List[int]):
    if isinstance(x, torch.Tensor):
        out = x.detach().cpu().numpy()
        nbytes.append(out.nbytes)
        return out
    if isinstance(x, dict):
        return {k: _host(v, nbytes) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v, nbytes) for v in x)
    return x


def to_host(tree):
    """``tree`` (a tensor, or a dict/list/tuple of them) with every tensor
    as a host numpy array.  Each tensor leaf is one copy, so callers pack
    what they read into one tensor first; reading a CUDA tensor waits for
    the work queued before it.  Counts calls, bytes and seconds
    (``device_get_*`` counters, and a ``device_get`` span while tracing
    is on)."""
    t0 = perf_counter()
    nbytes: List[int] = []
    out = _host(tree, nbytes)
    dt = perf_counter() - t0
    b = sum(nbytes)
    if trace.TRACER.enabled():
        trace.TRACER.add_complete("device_get", dt, bytes=b)
    REGISTRY.counter("device_get_calls",
                     help="to_host invocations").inc()
    REGISTRY.counter("device_get_bytes",
                     help="bytes transferred device->host").inc(b)
    REGISTRY.counter("device_get_s",
                     help="wall seconds inside to_host").inc(dt)
    return out


def device_get_stats() -> Dict[str, float]:
    """Totals collected by :func:`to_host` (zeros if never called, or
    since the registry was reset)."""
    def val(name):
        m = REGISTRY.get(name)
        return m.get() if m is not None else 0.0
    return {"calls": int(val("device_get_calls")),
            "bytes": int(val("device_get_bytes")),
            "total_s": val("device_get_s")}

