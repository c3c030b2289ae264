"""Host-side result reporting for repro_torch.dse (tables + JSON).

The counterpart of ``repro.dse.report``.

Two granularities:

* :func:`result_rows` — one row per candidate (label, portfolio cost,
  per-SKU unit costs, risk stats when present), for ranking tables.
* :func:`detail_rows` — one row per SKU of a single candidate with the
  full itemized breakdown, produced by ``CostEngine.as_rows`` on the
  candidate's own batch, so the columns are exactly the engine's
  (``raw_chips`` ... ``nre_total`` / ``total``).

Everything returns plain lists of dicts of Python floats — json.dumps
ready — plus a minimal fixed-width :func:`format_table` for terminals.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

from ..core.batch import SystemBatch
from ..core.engine import CostEngine
from .evaluate import CandidateResult
from .search import SearchResult
from .space import Candidate, DesignSpace, candidate_systems


def result_rows(results: Sequence[CandidateResult],
                top: Optional[int] = None) -> List[Dict]:
    """Per-candidate summary rows (input order preserved)."""
    rows = []
    for r in results[:top] if top is not None else results:
        row = {"candidate": r.label, "reuse": r.candidate.is_reuse,
               "portfolio_cost": float(r.portfolio_cost)}
        for name, u, re_u, nre_u in zip(r.sku_names, r.sku_unit_total,
                                        r.sku_unit_re, r.sku_unit_nre):
            row[f"{name}:unit"] = float(u)
            row[f"{name}:re"] = float(re_u)
            row[f"{name}:nre"] = float(nre_u)
        if r.risk:
            row.update({f"risk:{k}": float(v) for k, v in r.risk.items()})
        rows.append(row)
    return rows


def detail_rows(space: DesignSpace, cand: Candidate,
                engine: Optional[CostEngine] = None,
                flow: str = "chip-last", device=None) -> List[Dict]:
    """Engine-itemized per-SKU rows for one candidate
    (``CostEngine.as_rows`` column contract), priced on ``device`` (the
    GPU unless the caller names another)."""
    engine = engine or CostEngine()
    batch = SystemBatch.from_systems(candidate_systems(space, cand),
                                     share_nre=True, device=device)
    return engine.as_rows(batch, flow=flow)


def search_summary(res: SearchResult, top: int = 5) -> Dict:
    """JSON-ready digest of a search run."""
    return {
        "objective": res.objective_key,
        "best": {"candidate": res.best.label,
                 "portfolio_cost": float(res.best.portfolio_cost),
                 "objective": float(res.best.objective(res.objective_key)),
                 "risk": ({k: float(v) for k, v in res.best.risk.items()}
                          if res.best.risk else None)},
        "top": result_rows(res.top(top)),
        "pareto": [{k: (v if isinstance(v, str) else float(v))
                    for k, v in p.items() if k != "candidate"}
                   for p in res.pareto],
        "n_evaluated": res.n_evaluated,
        "history": res.history,
    }


def format_table(rows: Sequence[Dict],
                 columns: Optional[Sequence[str]] = None) -> str:
    """Fixed-width text table; floats >= 1000 rendered with separators."""
    if not rows:
        return "(no rows)"
    cols = list(columns) if columns else list(rows[0].keys())

    def fmt(v):
        if isinstance(v, bool) or v is None:
            return str(v)
        if isinstance(v, float):
            return f"{v:,.0f}" if abs(v) >= 1000 else f"{v:.4g}"
        return str(v)

    table = [[fmt(r.get(c, "")) for c in cols] for r in rows]
    widths = [max(len(c), *(len(t[i]) for t in table))
              for i, c in enumerate(cols)]
    lines = ["  ".join(c.ljust(w) for c, w in zip(cols, widths))]
    lines.append("  ".join("-" * w for w in widths))
    for t in table:
        lines.append("  ".join(v.rjust(w) for v, w in zip(t, widths)))
    return "\n".join(lines)


def to_json(obj, indent: int = 2) -> str:
    """json.dumps with a default that copes with numpy scalars/arrays."""
    def default(o):
        if hasattr(o, "tolist"):
            return o.tolist()
        if hasattr(o, "item"):
            return o.item()
        return str(o)
    return json.dumps(obj, indent=indent, default=default)
