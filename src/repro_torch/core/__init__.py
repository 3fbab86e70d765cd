"""FlexPie core for the PyTorch port: layer IR, partition geometry, cost
physics and the DP planner (numpy; no tensors)."""
from .graph import (GRAPH_INPUT, Branch, ConvT, LayerSpec, ModelGraph, chain,
                    conv_geometries, halo_growth, shard_halo_pads)
from .partition import ALL_SCHEMES, Mode, Scheme
from .cost import Testbed, Topology
from .estimator import AnalyticEstimator, CostEstimator
from .plan import Plan, fixed_plan, plan_cost, plan_feasible, steps_segments
from .dpp import SearchResult, plan_search

__all__ = [
    "GRAPH_INPUT", "Branch", "ConvT", "LayerSpec", "ModelGraph", "chain",
    "conv_geometries", "halo_growth", "shard_halo_pads", "ALL_SCHEMES",
    "Mode", "Scheme", "Testbed", "Topology", "AnalyticEstimator",
    "CostEstimator", "Plan", "fixed_plan", "plan_cost", "plan_feasible",
    "steps_segments", "SearchResult", "plan_search",
]
