"""Host-side numerical guardrails (the counterpart of
``repro.resilience.guards``).

Two validators, numpy + stdlib (and torch for tensor leaves) only:

* :func:`nonfinite_paths` — walk an arbitrary request-shaped object
  (dataclasses, dicts, sequences, numpy arrays, tensors, scalars) and
  return human-readable paths of every NaN/Inf numeric leaf.  The service
  protocol layer uses it to reject a request with ``invalid_request``
  *before* the bad value can reach a fused chunk and contaminate
  coalesced siblings.  A ``torch.Tensor`` leaf is scanned as an array
  (on the host: validation runs at admission, off the tick loop), where
  the reference lets an opaque object pass.
* :func:`validate_packed_arrays` — range checks over the staged
  ``SystemBatch.from_systems`` host arrays (all values finite,
  areas/costs/quantities non-negative, yields inside (0, 1],
  ``package_area_factor`` strictly positive since the engine divides by
  it) before they are copied to the device.  Padded slots (zero areas,
  unit yields) are legal by construction.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Sequence

import numpy as np
import torch

# Stop after this many problems: error envelopes should name the first
# offenders, not serialize a million-row array of NaNs.
_MAX_PROBLEMS = 8


def _scan_array(arr: np.ndarray, path: str, problems: List[str]):
    if arr.dtype.kind not in "fc":
        return
    finite = np.isfinite(arr)
    if finite.all():
        return
    flat_bad = np.flatnonzero(~finite.reshape(-1))
    for pos in flat_bad[:2]:
        idx = np.unravel_index(int(pos), arr.shape) if arr.ndim else ()
        loc = "".join(f"[{int(i)}]" for i in idx)
        problems.append(f"{path}{loc} = {arr.reshape(-1)[int(pos)]}")
        if len(problems) >= _MAX_PROBLEMS:
            return


def nonfinite_paths(obj: Any, path: str = "value",
                    _depth: int = 0) -> List[str]:
    """Paths of non-finite numeric leaves in ``obj`` (empty = clean)."""
    problems: List[str] = []
    _walk_nonfinite(obj, path, problems, _depth)
    return problems


def _walk_nonfinite(obj: Any, path: str, problems: List[str], depth: int):
    if len(problems) >= _MAX_PROBLEMS or depth > 8 or obj is None:
        return
    # bool is an int subclass; int/bool/str can't be non-finite.
    if isinstance(obj, (bool, int, str, bytes, np.integer, np.bool_)):
        return
    if isinstance(obj, (float, np.floating, complex, np.complexfloating)):
        if not np.isfinite(obj):
            problems.append(f"{path} = {obj}")
        return
    if isinstance(obj, np.ndarray):
        _scan_array(obj, path, problems)
        return
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        _scan_array(t.numpy(), path, problems)
        return
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _walk_nonfinite(getattr(obj, f.name), f"{path}.{f.name}",
                            problems, depth + 1)
        return
    if isinstance(obj, Mapping):
        for k, v in obj.items():
            _walk_nonfinite(v, f"{path}[{k!r}]", problems, depth + 1)
        return
    if isinstance(obj, Sequence):
        # Fast path: an all-numeric sequence vectorizes to one isfinite.
        try:
            arr = np.asarray(obj, dtype=np.float64)
        except (TypeError, ValueError, RuntimeError):
            arr = None
        if arr is not None and arr.dtype.kind == "f":
            _scan_array(arr, path, problems)
            return
        for i, v in enumerate(obj):
            _walk_nonfinite(v, f"{path}[{i}]", problems, depth + 1)
        return
    # Opaque object: passes (Uncertainty et al. are dataclasses and
    # recurse).


# ---------------------------------------------------------------------------
# SystemBatch staging-array validation
# ---------------------------------------------------------------------------

# Per-chip (n_systems, max_chips) staged arrays: bound kind per key.
_CHIP_NONNEG = ("area", "defect", "wafer_cost", "cluster", "sort_cost",
                "bump_cost")
_CHIP_YIELD = ("wafer_yield",)
# Per-system (n_systems,) staged arrays.
_SYS_NONNEG = ("package_area", "substrate_cost", "substrate_layer",
               "interposer_cost", "interposer_defect",
               "interposer_area_factor", "interposer_cluster",
               "bond_cost_per_chip", "quantity")
_SYS_YIELD = ("y2_chip_bond", "y3_substrate_bond", "assembly_yield")
_SYS_POSITIVE = ("package_area_factor",)   # engine divides by it


def _offenders(mask: np.ndarray, arr: np.ndarray, key: str,
               names: Sequence[str], problems: List[str]):
    """Append ``system 'name': key[j] = value`` lines for True mask
    slots (mask/arr are the staged (n,) or (n, c) arrays)."""
    bad = np.flatnonzero(mask.reshape(-1))
    for pos in bad[:2]:
        if arr.ndim == 2:
            i, j = np.unravel_index(int(pos), arr.shape)
            loc = f"{key}[{int(j)}]"
        else:
            i, loc = int(pos), key
        name = names[int(i)] if int(i) < len(names) else f"#{int(i)}"
        problems.append(f"system {name!r}: {loc} = {arr.reshape(-1)[int(pos)]}")
        if len(problems) >= _MAX_PROBLEMS:
            return


def validate_packed_arrays(chip: Mapping[str, np.ndarray],
                           system: Mapping[str, np.ndarray],
                           names: Sequence[str]) -> List[str]:
    """Range-check the ``from_systems`` staging arrays; returns problem
    strings (empty = valid).  ``chip`` maps the per-chip keys to
    (n_systems, max_chips) arrays with a ``mask`` entry marking filled
    slots; ``system`` maps per-system keys to (n_systems,) arrays."""
    problems: List[str] = []
    slot = np.asarray(chip["mask"], bool)

    for key, arr in chip.items():
        a = np.asarray(arr)
        _offenders(~np.isfinite(a) & slot, a, key, names, problems)
    for key, arr in system.items():
        a = np.asarray(arr)
        _offenders(~np.isfinite(a), a, key, names, problems)
    if problems:
        return problems[:_MAX_PROBLEMS]

    for key in _CHIP_NONNEG:
        a = np.asarray(chip[key])
        _offenders((a < 0.0) & slot, a, key, names, problems)
    for key in _CHIP_YIELD:
        a = np.asarray(chip[key])
        _offenders(((a <= 0.0) | (a > 1.0)) & slot, a, key, names, problems)
    for key in _SYS_NONNEG:
        a = np.asarray(system[key])
        _offenders(a < 0.0, a, key, names, problems)
    for key in _SYS_YIELD:
        a = np.asarray(system[key])
        _offenders((a <= 0.0) | (a > 1.0), a, key, names, problems)
    for key in _SYS_POSITIVE:
        a = np.asarray(system[key])
        _offenders(a <= 0.0, a, key, names, problems)
    return problems[:_MAX_PROBLEMS]
