"""repro_torch.dse — portfolio-scale design-space exploration.

The counterpart of ``repro.dse``: the search layer on top of
:class:`~repro_torch.core.engine.CostEngine`, on the GPU unless the
caller names the CPU (``device="cpu"``):

  space        -- declarative DesignSpace (SKUs, nodes, integrations,
                  chiplet counts, cross-SKU reuse) + candidate algebra
  evaluate     -- ChunkedEvaluator: constant-shape padded SystemBatch
                  chunks priced on the device, one host copy a sweep
  uncertainty  -- Monte Carlo cost distributions (a batch of scenario
                  keys through the engine) and grad-based sensitivities
  search       -- evolutionary portfolio optimizer (+ exhaustive
                  cross-check), deterministic in an explicit PRNG key
  report       -- candidate/SKU result tables, CostEngine.as_rows
                  compatible, JSON-ready

Quickstart::

    from repro_torch import random
    from repro_torch.dse import DesignSpace, SKU, portfolio_search

    space = DesignSpace(
        skus=(SKU("laptop", 300.0, 2e6), SKU("desktop", 600.0, 1e6),
              SKU("server", 900.0, 3e5)),
        processes=("5nm", "7nm"), integrations=("MCM", "2.5D"),
        chiplet_counts=(1, 2, 3, 4, 6))
    res = portfolio_search(space, random.PRNGKey(0))      # on the GPU
    print(res.best.label, res.best.portfolio_cost)
"""
from .space import (ArchChoice, Candidate, CandidateEncoder, DesignSpace,
                    EncoderMeta, ReuseChoice, SKU, candidate_systems,
                    encode_arrays, encode_batch)
from .evaluate import (CandidateResult, ChunkShape, ChunkedEvaluator,
                       EvalArrays, chunk_shape, evaluate_direct)
from .uncertainty import (SENSITIVITY_PARAMS, Uncertainty, mc_summary,
                          mc_totals, portfolio_draws, portfolio_risk_stats,
                          sensitivities)
from .search import (RiskConfig, SearchResult, SearchState,
                     exhaustive_search, portfolio_search)
from .report import (detail_rows, format_table, result_rows, search_summary,
                     to_json)

__all__ = [
    "ArchChoice", "Candidate", "CandidateEncoder", "DesignSpace",
    "EncoderMeta", "ReuseChoice", "SKU", "candidate_systems",
    "encode_arrays", "encode_batch", "CandidateResult", "ChunkShape",
    "ChunkedEvaluator", "EvalArrays", "chunk_shape", "evaluate_direct",
    "SENSITIVITY_PARAMS", "Uncertainty", "mc_summary", "mc_totals",
    "portfolio_draws", "portfolio_risk_stats", "sensitivities",
    "RiskConfig", "SearchResult", "SearchState", "exhaustive_search",
    "portfolio_search",
    "detail_rows", "format_table", "result_rows", "search_summary",
    "to_json",
]
