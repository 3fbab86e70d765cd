"""The five baselines of §4 plus FlexPie itself, as planner policies.

  one_dim_inh   — MoDNN / DeepSlicing (One-dim InH/InW, all-T)
  one_dim_outc  — Xenos (One-dim OutC, all-T)
  grid_2d       — DeepThings (2D-grid, all-T)
  layerwise     — DINA / PartialDI (per-layer best scheme, no fusion)
  fused_fixed   — AOFL / EdgeCI (single fixed scheme, fusion T/NT optimized)
  flexpie       — full FCO (schemes x fusion jointly)

A copy of the JAX package's ``core/baselines.py``.
"""
from __future__ import annotations

from typing import Dict, Tuple

from .cost import Testbed
from .cost_tables import PrefetchedEstimator
from .dpp import SearchResult, plan_search
from .estimator import CostEstimator
from .graph import ModelGraph
from .partition import ALL_SCHEMES, Scheme
from .plan import Plan, fixed_plan, plan_cost


def one_dim(graph: ModelGraph, est: CostEstimator, tb: Testbed,
            scheme: Scheme) -> Tuple[Plan, float]:
    plan = fixed_plan(graph, scheme)
    # all-T single-scheme plan: prefetch its n i-costs and n-1 s-costs in
    # one batched call instead of 2n-1 scalar ones
    pf = PrefetchedEstimator.for_graph(graph, est, tb, (scheme,),
                                       allow_fusion=False)
    return plan, plan_cost(graph, plan, pf, tb)


def layerwise(graph: ModelGraph, est: CostEstimator,
              tb: Testbed) -> Tuple[Plan, float]:
    res = plan_search(graph, est, tb, schemes=ALL_SCHEMES, allow_fusion=False)
    return res.plan, res.cost


def fused_fixed(graph: ModelGraph, est: CostEstimator, tb: Testbed,
                scheme: Scheme = Scheme.INH) -> Tuple[Plan, float]:
    res = plan_search(graph, est, tb, schemes=(scheme,), allow_fusion=True)
    return res.plan, res.cost


def flexpie(graph: ModelGraph, est: CostEstimator,
            tb: Testbed) -> SearchResult:
    return plan_search(graph, est, tb, schemes=ALL_SCHEMES, allow_fusion=True)


def all_solutions(graph: ModelGraph, est: CostEstimator,
                  tb: Testbed) -> Dict[str, Tuple[Plan, float]]:
    """Every solution's (plan, estimated time) — one row of Fig. 7/9."""
    out: Dict[str, Tuple[Plan, float]] = {}
    out["one_dim_inh"] = one_dim(graph, est, tb, Scheme.INH)
    out["one_dim_outc"] = one_dim(graph, est, tb, Scheme.OUTC)
    out["grid_2d"] = one_dim(graph, est, tb, Scheme.GRID2D)
    out["layerwise"] = layerwise(graph, est, tb)
    out["fused_fixed"] = fused_fixed(graph, est, tb)
    r = flexpie(graph, est, tb)
    out["flexpie"] = (r.plan, r.cost)
    return out


def performance_scores(times: Dict[str, float]) -> Dict[str, float]:
    """§4 Metrics: score_i = min(t_1..t_m) / t_i  (1.0 = best)."""
    best = min(times.values())
    return {k: best / v for k, v in times.items()}
