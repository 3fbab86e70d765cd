"""FlexPie core for the PyTorch port: layer IR, partition geometry, cost
physics and the DP planner (numpy; no tensors)."""
from .graph import (GRAPH_INPUT, Branch, ConvT, LayerSpec, ModelGraph, chain,
                    conv_geometries, halo_growth, shard_halo_pads)
from .partition import (ALL_SCHEMES, Mode, Scheme, hetero_shard_work,
                        weighted_split_sizes)
from .cost import (Testbed, Topology, hetero_compute_time_batch_s,
                   hetero_compute_time_s, hetero_device_times_s,
                   sync_bytes_messages)
from .estimator import AnalyticEstimator, CostEstimator
from .plan import (Plan, PipelineCost, fixed_plan, plan_cost, plan_feasible,
                   plan_pipeline_cost, plan_stage_counts, steps_segments)
from .dpp import (Objective, PlanFrontier, SearchResult, pipeline_frontier,
                  pipeline_objective_key, plan_search)

__all__ = [
    "GRAPH_INPUT", "Branch", "ConvT", "LayerSpec", "ModelGraph", "chain",
    "conv_geometries", "halo_growth", "shard_halo_pads", "ALL_SCHEMES",
    "Mode", "Scheme", "hetero_shard_work", "weighted_split_sizes",
    "Testbed", "Topology", "hetero_compute_time_batch_s",
    "hetero_compute_time_s", "hetero_device_times_s", "sync_bytes_messages",
    "AnalyticEstimator", "CostEstimator", "Plan", "PipelineCost",
    "fixed_plan", "plan_cost", "plan_feasible", "plan_pipeline_cost",
    "plan_stage_counts", "steps_segments", "Objective", "PlanFrontier",
    "SearchResult", "pipeline_frontier", "pipeline_objective_key",
    "plan_search",
]
