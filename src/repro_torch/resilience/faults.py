"""Deterministic, seed-keyed fault injection behind ``REPRO_FAULTS``.

A copy of the JAX package's ``resilience/faults.py``: the same kinds and
the same string-seeded streams, so one spec fires on the same checks in
both packages.

The service asks the injector "does fault *kind* fire now?" at fixed
call sites; the injector answers from a per-kind ``random.Random``
stream keyed ``f"{seed}:{kind}:{check_number}"``.  String seeding goes
through SHA-512 inside :class:`random.Random`, so the same spec produces
the same fire/no-fire sequence in every process regardless of
``PYTHONHASHSEED`` — a chaos run is a *schedule*, not a dice roll.

Spec grammar (the value of the ``REPRO_FAULTS`` env var)::

    seed=42;dispatch_error:p=0.3;stall:p=1.0,ms=1500,n=1;poison:p=0.2

``seed=N`` (optional, default 0) keys every stream; each remaining
``kind:opts`` token enables one fault kind with per-check probability
``p`` (required), an optional payload ``ms`` (stall duration), and an
optional lifetime cap ``n`` (max total fires).  Kinds:

===============  ============================================================
dispatch_error   raise :class:`InjectedFault` from the fused kernel dispatch
stall            sleep ``ms`` inside a tick (drives the watchdog)
poison           overwrite one priced row with NaN after the host fetch
flood            force one admission to report queue_full (backpressure)
recompile        make the fused probe forget its seen argument signatures,
                 so the next dispatch is a metered first call
crash            simulate process death at a tick boundary: in-flight
                 futures get typed ``shutting_down`` envelopes, NO journal
                 terminals are written, and the loop halts — a subsequent
                 resume must replay the journal (drives chaos/restart
                 benches; usually ``n=1``)
===============  ============================================================

A constructed injector with no rules is **falsy**; every production call
site guards with ``if self.faults:`` first, so the disabled path costs
one truthiness check and the hot loop stays allocation-free.
"""
from __future__ import annotations

import dataclasses
import os
import random
from typing import Dict, Optional, Tuple

ENV_VAR = "REPRO_FAULTS"

FAULT_KINDS = ("dispatch_error", "stall", "poison", "flood", "recompile",
               "crash")


class InjectedFault(RuntimeError):
    """Raised by injected ``dispatch_error`` faults (and only by them —
    catching it specifically lets tests distinguish injected failures
    from real ones)."""

    def __init__(self, kind: str, message: str = ""):
        super().__init__(message or f"injected fault: {kind}")
        self.kind = kind


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One enabled fault kind: fire with probability ``prob`` per check,
    at most ``max_fires`` times total; ``ms`` is the stall payload."""

    kind: str
    prob: float
    ms: float = 0.0
    max_fires: Optional[int] = None


def parse_fault_spec(spec: str) -> Tuple[int, Dict[str, FaultRule]]:
    """Parse a ``REPRO_FAULTS`` spec into ``(seed, {kind: rule})``.

    Raises :class:`ValueError` on unknown kinds/options or malformed
    numbers — a chaos run with a typo'd schedule must fail loudly, not
    silently run fault-free.
    """
    seed = 0
    rules: Dict[str, FaultRule] = {}
    for token in spec.split(";"):
        token = token.strip()
        if not token:
            continue
        if token.startswith("seed="):
            seed = int(token[len("seed="):])
            continue
        kind, _, opt_str = token.partition(":")
        kind = kind.strip()
        if kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} in {ENV_VAR} spec "
                f"(known: {', '.join(FAULT_KINDS)})")
        opts: Dict[str, float] = {}
        for opt in opt_str.split(","):
            opt = opt.strip()
            if not opt:
                continue
            name, _, val = opt.partition("=")
            if name not in ("p", "ms", "n") or not val:
                raise ValueError(
                    f"bad option {opt!r} for fault {kind!r} "
                    f"(expected p=<prob>[,ms=<millis>][,n=<max fires>])")
            opts[name] = float(val)
        if "p" not in opts:
            raise ValueError(f"fault {kind!r} needs p=<prob>")
        prob = opts["p"]
        if not 0.0 <= prob <= 1.0:
            raise ValueError(f"fault {kind!r}: p={prob} outside [0, 1]")
        rules[kind] = FaultRule(
            kind=kind, prob=prob, ms=float(opts.get("ms", 0.0)),
            max_fires=int(opts["n"]) if "n" in opts else None)
    return seed, rules


class FaultInjector:
    """Seed-keyed fault scheduler (see module docstring).

    ``fire(kind)`` returns the kind's :class:`FaultRule` when the fault
    fires at this check and ``None`` otherwise; the caller enacts the
    fault (raise / sleep / mutate).  Check counts and fire counts are
    tracked per kind for ``stats()``.
    """

    def __init__(self, spec: str = ""):
        self.spec = spec or ""
        self.seed, self.rules = parse_fault_spec(self.spec)
        self.checked: Dict[str, int] = {k: 0 for k in self.rules}
        self.fired: Dict[str, int] = {k: 0 for k in self.rules}

    @classmethod
    def from_env(cls) -> "FaultInjector":
        return cls(os.environ.get(ENV_VAR, ""))

    def __bool__(self) -> bool:
        return bool(self.rules)

    def fire(self, kind: str) -> Optional[FaultRule]:
        rule = self.rules.get(kind)
        if rule is None:
            return None
        n = self.checked[kind]
        self.checked[kind] = n + 1
        if rule.max_fires is not None and self.fired[kind] >= rule.max_fires:
            return None
        # One fresh, deterministically keyed stream per check: outcome
        # number n for a kind never depends on how often *other* kinds
        # were checked, so interleaving changes don't reshuffle the
        # schedule.
        if random.Random(f"{self.seed}:{kind}:{n}").random() >= rule.prob:
            return None
        self.fired[kind] += 1
        return rule

    def rng(self, kind: str, n: int) -> random.Random:
        """A deterministic side-stream for fault payloads (e.g. which
        row to poison), keyed like the fire streams."""
        return random.Random(f"{self.seed}:{kind}#payload:{n}")

    def stats(self) -> Dict[str, object]:
        return {
            "enabled": bool(self.rules),
            "spec": self.spec,
            "seed": self.seed,
            "checked": dict(self.checked),
            "fired": dict(self.fired),
        }
