"""repro_torch.resilience — failure handling for the pricing stack (the
counterpart of ``repro.resilience``).

Four small, dependency-light building blocks (stdlib + numpy, and torch
only to read tensor leaves; no imports from the rest of ``repro_torch``):

* :mod:`~repro_torch.resilience.faults` — deterministic, seed-keyed
  fault injection behind the ``REPRO_FAULTS`` env var (disabled
  injectors are falsy, so production hot paths pay one truthiness
  check).
* :mod:`~repro_torch.resilience.retry` — retry-with-backoff and a
  closed/open/half-open :class:`CircuitBreaker` for the fused-dispatch
  degradation path.
* :mod:`~repro_torch.resilience.guards` — host-side numerical
  validation: non-finite walks over request objects and range checks
  over packed system arrays.
* :mod:`~repro_torch.resilience.watchdog` — a heartbeat thread that
  detects a stuck service tick and fires a one-per-stall callback (the
  server uses it to auto-dump the flight recorder).
"""
from .faults import (FAULT_KINDS, FaultInjector, FaultRule, InjectedFault,
                     parse_fault_spec)
from .guards import nonfinite_paths, validate_packed_arrays
from .retry import CircuitBreaker, RetryPolicy, call_with_retry
from .watchdog import Watchdog

__all__ = [
    "FAULT_KINDS", "FaultInjector", "FaultRule", "InjectedFault",
    "parse_fault_spec",
    "nonfinite_paths", "validate_packed_arrays",
    "CircuitBreaker", "RetryPolicy", "call_with_retry",
    "Watchdog",
]
