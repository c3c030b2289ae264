"""Op counter of a torch step: the port's counterpart of the JAX package's
HLO analyzer (``repro/analysis/hlo.py``).

Nothing in the port emits HLO, so nothing is parsed: :class:`OpCounter`
is a ``TorchDispatchMode`` that sees every ATen op of a step as it runs,
on real tensors or on ``FakeTensor``s (the dry run), forward, backward
and remat recompute alike, and fills the same :class:`HLOCostReport`:

* ``flops``: matmul-class ops by ``torch.utils.flop_counter``'s formulas
  (the reference counts dots and convolutions); a hand-written kernel's
  call is counted by its own formula (``ops.py``, the one the bound
  column of ``PERF.md`` uses) and the ops inside it are not counted, so
  the kernel on the card and its plain version on fake tensors count the
  same;
* ``hbm_bytes``: operand plus output bytes of every ATen op that is not
  a view, the reference's buffer model without fusion; a kernel call its
  inputs read once and outputs written once;
* ``score_buffer_bytes`` / ``recurrent_buffer_bytes`` by the reference's
  rules: the traffic of fp32/bf16 tensors of rank >= 3 whose last
  dimension is a flash chunk, and, inside a recurrence of 512 steps or
  more (:func:`recurrence`), the traffic that is neither streamed in or
  out a step nor score-shaped; ``hbm_bytes_kernel_path`` is what remains;
* ``collective_bytes`` / ``collective_counts`` by type, as the mesh layer
  (``parallel/comm.py``) records them, per device;
* ``trip_counts``: the depths of the scanned layer stacks JAX's program
  has (:func:`scanned_stacks`), which the port unrolls.

It also tracks the bytes the step's ops allocate and free
(``peak_live_bytes``), the dry run's temp estimate.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast")
RECURRENT_TRIP = 512

# ops that write only part of their output (a step's slice of a stacked
# buffer): the reference's "streaming" slice-likes
_STREAMING = ("copy_", "index_put_", "index_put", "slice_scatter",
              "select_scatter", "index_select", "index", "gather",
              "scatter", "embedding")


@dataclasses.dataclass
class HLOCostReport:
    """Per-device totals of one traced step."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_counts: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    n_while: int = 0
    trip_counts: List[int] = dataclasses.field(default_factory=list)
    score_buffer_bytes: float = 0.0
    recurrent_buffer_bytes: float = 0.0
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    peak_live_bytes: float = 0.0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    @property
    def hbm_bytes_kernel_path(self) -> float:
        return max(0.0, self.hbm_bytes - self.score_buffer_bytes
                   - self.recurrent_buffer_bytes)

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collective_bytes": dict(self.collective_bytes),
            "collective_counts": dict(self.collective_counts),
            "total_collective_bytes": self.total_collective_bytes,
            "n_while": self.n_while, "trip_counts": list(self.trip_counts),
            "score_buffer_bytes": self.score_buffer_bytes,
            "recurrent_buffer_bytes": self.recurrent_buffer_bytes,
            "hbm_bytes_kernel_path": self.hbm_bytes_kernel_path,
            "kernel_calls": dict(self.kernel_calls),
            "peak_live_bytes": self.peak_live_bytes,
        }


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _score_shaped(t: torch.Tensor, chunks) -> bool:
    return bool(chunks) and t.dtype in (torch.float32, torch.bfloat16) \
        and t.dim() >= 3 and t.shape[-1] in chunks


class OpCounter(TorchDispatchMode):
    """Counts the ATen ops run under it into ``self.report``."""

    def __init__(self, score_chunks: Tuple[int, ...] = ()):
        super().__init__()
        self.report = HLOCostReport()
        self.score_chunks = tuple(score_chunks)
        self._inside = 0            # depth of kernel calls
        self._recurrence = 0        # depth of long recurrences
        self._live = 0

    # -- what the port's layers report --------------------------------
    def note_kernel(self, name: str, flops: float, nbytes: float) -> None:
        r = self.report
        r.kernel_calls[name] = r.kernel_calls.get(name, 0) + 1
        r.flops += flops
        r.hbm_bytes += nbytes

    def note_collective(self, kind: str, nbytes: float) -> None:
        r = self.report
        r.collective_bytes[kind] = r.collective_bytes.get(kind, 0.0) + nbytes
        r.collective_counts[kind] = r.collective_counts.get(kind, 0) + 1

    # -- every ATen op --------------------------------------------------
    def _free(self, n: int) -> None:
        self._live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten" or func.is_view:
            return out
        outs = _tensors(out)
        for t in outs:
            if t._base is None:
                n = _nbytes(t)
                self._live += n
                weakref.finalize(t, self._free, n)
        self.report.peak_live_bytes = max(self.report.peak_live_bytes,
                                          self._live)
        if self._inside:
            return out
        from torch.utils.flop_counter import flop_registry
        packet = func._overloadpacket
        if packet in flop_registry:
            self.report.flops += flop_registry[packet](*args, **kwargs,
                                                       out_val=out)
        ins = _tensors((args, kwargs))
        amount = sum(_nbytes(t) for t in ins + outs)
        if not amount:
            return out
        r = self.report
        r.hbm_bytes += amount
        credit = sum(_nbytes(t) for t in ins + outs
                     if _score_shaped(t, self.score_chunks))
        r.score_buffer_bytes += min(amount, credit)
        streaming = packet.__name__ in _STREAMING
        if self._recurrence and not streaming and credit == 0:
            r.recurrent_buffer_bytes += amount
        return out


def active() -> Optional[OpCounter]:
    """The innermost counter on this thread's dispatch-mode stack (which
    autograd carries into the backward and its recompute), or None."""
    if not torch._C._len_torch_dispatch_stack():
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, OpCounter):
            return mode
    return None


@contextlib.contextmanager
def kernel(name: str, cost: Callable[[], Tuple[float, float]]):
    """One hand-written kernel's call: counted as ``cost()`` = (flops,
    bytes) by an active counter, which counts none of the ops inside."""
    c = active()
    if c is None:
        yield
        return
    c.note_kernel(name, *cost())
    c._inside += 1
    try:
        yield
    finally:
        c._inside -= 1


@contextlib.contextmanager
def recurrence(trips: int):
    """A loop of ``trips`` steps over a state (the reference's while loop
    of a recurrence); at 512 steps or more its traffic is the reference's
    recurrent buffer."""
    c = active()
    if c is None or trips < RECURRENT_TRIP:
        yield
        return
    c._recurrence += 1
    try:
        yield
    finally:
        c._recurrence -= 1


def note_collective(kind: str, nbytes: float) -> None:
    c = active()
    if c is not None:
        c.note_collective(kind, nbytes)


def scanned_stacks(cfg, kind: str) -> List[int]:
    """Depths of the ``while`` loops over layers in JAX's program of a
    step: each stack of the attention families deeper than one layer
    (XLA unrolls a loop of one), once forward and, to train, once
    backward.  Other families' stacks are not listed."""
    if cfg.family not in ("dense", "moe", "vlm") or not cfg.scan_layers:
        return []
    depths = [cfg.n_layers]
    if cfg.family == "moe" and cfg.first_dense:
        depths = [cfg.first_dense, cfg.n_layers - cfg.first_dense]
    depths = [d for d in depths if d > 1]
    return depths * (2 if kind == "train" else 1)


def count(fn: Callable, *args, score_chunks=(), **kwargs):
    """(``fn(*args, **kwargs)``, the report of its ops)."""
    counter = OpCounter(score_chunks)
    with counter:
        out = fn(*args, **kwargs)
    return out, counter.report
