"""Heterogeneous cluster subsystem: specs, weighted costing, simulator,
refinement on measured occupancy, serving objectives, elastic replanning
under churn.

Quick start::

    from repro_torch.cluster import (mixed_fast_slow, cluster_plan_search,
                                     simulate)
    cluster = mixed_fast_slow(6)            # 2 fast + 4 slow devices
    res = cluster_plan_search(graph, cluster)
    rep = simulate(graph, res.plan, cluster, n_requests=32)

Throughput planning refined on the mesh executor's measured occupancy::

    from repro_torch import ExecConfig, Session
    from repro_torch.cluster import (OnlineCalibrator, homogeneous,
                                     refine_with_simulator)
    cl = homogeneous(4, bandwidth_gbps=0.5)

    def measure(plan):
        sess = Session(graph, weights, plan, cl.n, ExecConfig(
            executor="mesh", overlap=False, instrument=True))
        for _ in range(3):
            _, stats = sess.run(x)
        return stats.to_occupancy()

    rr = refine_with_simulator(graph, cl, occupancy_fn=measure,
                               calibrator=OnlineCalibrator(cl))

Planning on learned costs: ``estimator=ClusterGBDTEstimator(est, cl)``
with ``est`` from ``repro_torch.sim.train_estimators(
hetero_trace_config())``.

Elastic clusters: ``ElasticPlanner(graph).replan(registry.cluster(), ...)``
on a ``DeviceRegistry``; ``compare_strategies(graph, cluster,
scenario_mixed(cluster))`` replays churn under the three strategies.

The port of the JAX package's ``repro.cluster``; it exports the same
names.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.dpp import (Objective, PlanFrontier, SearchResult,
                                  pipeline_frontier, plan_search)
from repro_torch.core.graph import ModelGraph
from repro_torch.core.partition import ALL_SCHEMES, Scheme

from .churn import (CHURN_SCENARIOS, STRATEGIES, ChurnEvent, ChurnRunResult,
                    ChurnScenario, compare_strategies, random_scenario,
                    run_churn)
from .elastic import (CapacityError, DeviceRegistry, DeviceState,
                      ElasticPlanner, Member, MembershipError, MigrationCost,
                      ReplanDecision, migration_cost_s, plan_device_bytes,
                      plan_memory_ok)
from .calibrate import (CalibrationSample, OnlineCalibrator,
                        fold_queueing_delay)
from .estimator import ClusterAnalyticEstimator, ClusterGBDTEstimator
from .refine import (RefineOscillationError, RefineResult, RefineStep,
                     refine_with_simulator)
from .serving import (DecodeServingReport, ServingPoint, choose_batch,
                      max_goodput, plan_decode_serving, serve_decode,
                      serve_point, sweep_serving)
from .simsched import (SimReport, Stage, build_stages, export_sim_trace,
                       simulate, simulate_trace)
from .spec import (CLUSTER_PRESETS, ClusterSpec, DeviceSpec, LinkSpec,
                   asym_uplink, homogeneous, mixed_fast_slow, stepped,
                   topology_edges)


def cluster_plan_search(graph: ModelGraph, cluster: ClusterSpec,
                        weighted: bool = True,
                        schemes: Sequence[Scheme] = ALL_SCHEMES,
                        max_segment: int = 32,
                        allow_fusion: bool = True,
                        objective: Objective = Objective.LATENCY,
                        latency_bound_s: Optional[float] = None,
                        estimator=None) -> SearchResult:
    """DPP over a cluster: batched tables throughout (the cluster estimator
    implements the full batched protocol, so heterogeneous layouts never
    fall back to scalar calls).  ``weighted=False`` plans with even shard
    fractions on the same silicon — the homogeneous-assumption baseline.
    ``objective`` selects the serving objective (single-shot latency,
    pipelined throughput, or p99-bounded throughput).  ``estimator``
    overrides the analytic cluster estimator — pass a
    :class:`ClusterGBDTEstimator` bound to this cluster to plan on
    learned costs (it must be bound to the same cluster; the testbed
    check enforces the projection)."""
    est = estimator if estimator is not None else \
        ClusterAnalyticEstimator(cluster, weighted=weighted)
    return plan_search(graph, est, cluster.compat_testbed(), schemes=schemes,
                       max_segment=max_segment, allow_fusion=allow_fusion,
                       objective=objective, latency_bound_s=latency_bound_s)


def cluster_pipeline_frontier(graph: ModelGraph, cluster: ClusterSpec,
                              weighted: bool = True,
                              schemes: Sequence[Scheme] = ALL_SCHEMES,
                              max_segment: int = 32,
                              allow_fusion: bool = True,
                              ub_cost: Optional[float] = None,
                              prune_ub: bool = True,
                              estimator=None) -> PlanFrontier:
    """The (compute, sync) Pareto frontier of all plans on this cluster —
    one build serves every objective selection and the simulator-in-the-
    loop refinement.  Pass ``prune_ub=False`` when the frontier will be
    re-weighted (``refine_with_simulator``), ``ub_cost`` to reuse an
    already-computed latency optimum (see ``core.pipeline_frontier``),
    ``estimator`` to build the frontier on learned costs
    (:class:`ClusterGBDTEstimator`) instead of the analytic model."""
    est = estimator if estimator is not None else \
        ClusterAnalyticEstimator(cluster, weighted=weighted)
    return pipeline_frontier(graph, est, cluster.compat_testbed(),
                             schemes=schemes, max_segment=max_segment,
                             allow_fusion=allow_fusion, ub_cost=ub_cost,
                             prune_ub=prune_ub)


__all__ = [
    "CHURN_SCENARIOS", "CLUSTER_PRESETS", "CalibrationSample",
    "CapacityError", "ChurnEvent", "ChurnRunResult", "ChurnScenario",
    "ClusterAnalyticEstimator", "ClusterGBDTEstimator", "ClusterSpec",
    "DeviceRegistry",
    "DeviceSpec", "DeviceState", "ElasticPlanner", "LinkSpec", "Member",
    "MembershipError", "MigrationCost", "Objective", "OnlineCalibrator",
    "PlanFrontier",
    "RefineOscillationError", "RefineResult", "RefineStep",
    "ReplanDecision", "STRATEGIES", "ServingPoint", "SimReport", "Stage",
    "asym_uplink", "build_stages", "choose_batch",
    "cluster_pipeline_frontier", "cluster_plan_search",
    "compare_strategies", "export_sim_trace", "fold_queueing_delay",
    "homogeneous",
    "max_goodput", "migration_cost_s", "mixed_fast_slow",
    "DecodeServingReport", "plan_decode_serving", "serve_decode",
    "plan_device_bytes", "plan_memory_ok", "random_scenario",
    "refine_with_simulator", "run_churn", "serve_point", "simulate",
    "simulate_trace", "stepped", "sweep_serving", "topology_edges",
]
