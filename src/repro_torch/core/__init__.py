"""FlexPie core for the PyTorch port: layer IR, partition geometry, cost
physics, the cost estimators, the DP planner with its exhaustive oracle and
the paper's baselines (numpy; the GBDT estimator's forests are tensors)."""
from .graph import (GRAPH_INPUT, Branch, ConvT, LayerSpec, ModelGraph, chain,
                    conv_geometries, halo_growth, shard_halo_pads)
from .partition import (ALL_SCHEMES, Mode, Scheme, hetero_shard_work,
                        weighted_split_sizes)
from .cost import (Testbed, Topology, hetero_compute_time_batch_s,
                   hetero_compute_time_s, hetero_device_times_s,
                   sync_bytes_messages)
from .estimator import (HETERO_FEATURE_NAMES, I_FEATURE_NAMES,
                        I_FEATURE_NAMES_HETERO, N_HETERO_FEATURES,
                        S_FEATURE_NAMES, S_FEATURE_NAMES_HETERO,
                        AnalyticEstimator, BatchedCostEstimator,
                        CostEstimator, GBDTEstimator, hetero_summary,
                        testbed_summary)
from .cost_tables import (ChainTables, CostTableBuilder, PrefetchedEstimator,
                          build_chain_tables)
from .plan import (Plan, PipelineCost, dag_plan_cost, fixed_plan, plan_cost,
                   plan_feasible, plan_pipeline_cost, plan_stage_counts,
                   steps_segments)
from .dpp import (Objective, PlanFrontier, SearchResult, pipeline_frontier,
                  pipeline_objective_key, plan_search, plan_search_reference)
from .exhaustive import enumerate_dag_plans, exhaustive_search
from . import baselines

__all__ = [
    "GRAPH_INPUT", "Branch", "ConvT", "LayerSpec", "ModelGraph", "chain",
    "conv_geometries", "halo_growth", "shard_halo_pads", "ALL_SCHEMES",
    "Mode", "Scheme", "hetero_shard_work", "weighted_split_sizes",
    "Testbed", "Topology", "hetero_compute_time_batch_s",
    "hetero_compute_time_s", "hetero_device_times_s", "sync_bytes_messages",
    "AnalyticEstimator", "BatchedCostEstimator", "CostEstimator",
    "GBDTEstimator", "HETERO_FEATURE_NAMES", "I_FEATURE_NAMES",
    "I_FEATURE_NAMES_HETERO", "N_HETERO_FEATURES", "S_FEATURE_NAMES",
    "S_FEATURE_NAMES_HETERO", "hetero_summary", "testbed_summary",
    "ChainTables", "CostTableBuilder", "PrefetchedEstimator",
    "build_chain_tables", "Plan", "PipelineCost", "dag_plan_cost",
    "fixed_plan", "plan_cost", "plan_feasible", "plan_pipeline_cost",
    "plan_stage_counts", "steps_segments", "Objective", "PlanFrontier",
    "SearchResult", "pipeline_frontier", "pipeline_objective_key",
    "plan_search", "plan_search_reference", "enumerate_dag_plans",
    "exhaustive_search", "baselines",
]
