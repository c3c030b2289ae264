"""Host-side numerical guardrail of ``SystemBatch.from_systems``.

:func:`validate_packed_arrays` range-checks the staged host arrays (all
values finite, areas/costs/quantities non-negative, yields inside (0, 1],
``package_area_factor`` strictly positive since the engine divides by it)
before they are copied to the device.  Padded slots (zero areas, unit
yields) are legal by construction.  numpy + stdlib only.
"""
from __future__ import annotations

from typing import List, Mapping, Sequence

import numpy as np

# Stop after this many problems: error envelopes should name the first
# offenders, not serialize a million-row array of NaNs.
_MAX_PROBLEMS = 8

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
