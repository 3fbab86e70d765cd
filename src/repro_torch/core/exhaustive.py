"""Brute-force search over the full (scheme, mode) space.

Used only for small graphs: the Theorem-1 property tests compare DPP's result
against this oracle under the same plan-validity constraints.  Branched
graphs enumerate per-branch chain plans (merge layers pinned to T-mode
singleton segments, branch tails always T) and take the product across
branches, scoring with the shared ``dag_plan_cost`` semantics.

A copy of the JAX package's ``core/exhaustive.py``.
"""
from __future__ import annotations

import itertools
from typing import Iterator, List, Optional, Sequence, Tuple

from .cost import Testbed
from .cost_tables import PrefetchedEstimator
from .dpp import Objective, pipeline_objective_key
from .estimator import CostEstimator
from .graph import ModelGraph
from .partition import ALL_SCHEMES, Mode, Scheme
from .plan import Plan, plan_cost, plan_feasible, plan_pipeline_cost


def enumerate_plans(n: int, schemes: Sequence[Scheme] = ALL_SCHEMES,
                    allow_fusion: bool = True) -> Iterator[Plan]:
    """All valid chain plans: segmentations x per-segment schemes.

    Multi-layer segments must use a single spatial scheme (see plan.py).
    """
    mode_opts = (Mode.T, Mode.NT) if allow_fusion else (Mode.T,)
    for modes in itertools.product(mode_opts, repeat=n - 1):
        modes = (*modes, Mode.T)
        # segment boundaries
        segs, a = [], 0
        for i, t in enumerate(modes):
            if t == Mode.T:
                segs.append((a, i))
                a = i + 1
        per_seg_choices = []
        for (sa, sb) in segs:
            if sb > sa:
                per_seg_choices.append([s for s in schemes if s.spatial])
            else:
                per_seg_choices.append(list(schemes))
        for combo in itertools.product(*per_seg_choices):
            steps: list = [None] * n
            for (sa, sb), s in zip(segs, combo):
                for m in range(sa, sb + 1):
                    steps[m] = (s, modes[m])
            yield Plan(tuple(steps))


def enumerate_dag_plans(graph: ModelGraph,
                        schemes: Sequence[Scheme] = ALL_SCHEMES,
                        allow_fusion: bool = True) -> Iterator[Plan]:
    """All valid plans of a branched graph: product of per-branch chain
    plans, with merge heads restricted to T-mode (junction sync points)."""
    branches = graph.linearize()
    per_branch: List[List[Plan]] = []
    for br in branches:
        plans = list(enumerate_plans(len(br.ids), schemes, allow_fusion))
        if graph.fan_in(br.head) >= 2:
            plans = [p for p in plans if p.steps[0][1] == Mode.T]
        per_branch.append(plans)
    n = len(graph)
    for combo in itertools.product(*per_branch):
        steps: list = [None] * n
        for br, p in zip(branches, combo):
            for idx, st in zip(br.ids, p.steps):
                steps[idx] = st
        yield Plan(tuple(steps))


def exhaustive_search(graph: ModelGraph, est: CostEstimator, tb: Testbed,
                      schemes: Sequence[Scheme] = ALL_SCHEMES,
                      allow_fusion: bool = True,
                      objective: Objective = Objective.LATENCY,
                      latency_bound_s: Optional[float] = None
                      ) -> Tuple[Plan, float]:
    """Oracle optimum under ``objective``.  Returns ``(plan, cost)`` where
    ``cost`` is the latency for ``LATENCY`` and the pipeline bottleneck
    time for the throughput objectives (scored with
    ``plan.plan_pipeline_cost`` and ordered by the same
    ``pipeline_objective_key`` the DP frontier selection uses)."""
    # one batched prefetch answers every estimator query the enumeration
    # can make (the plan space revisits the same segments endlessly, so
    # scoring degenerates to dict lookups)
    pf = PrefetchedEstimator.for_graph(graph, est, tb, schemes, allow_fusion)
    best: Optional[Plan] = None
    gen = (enumerate_plans(len(graph), schemes, allow_fusion)
           if graph.is_chain
           else enumerate_dag_plans(graph, schemes, allow_fusion))
    if objective != Objective.LATENCY:
        best_key: Optional[tuple] = None
        best_bottleneck = float("inf")
        for plan in gen:
            if not plan_feasible(graph, plan, tb.nodes):
                continue
            pc = plan_pipeline_cost(graph, plan, pf, tb)
            key = pipeline_objective_key(pc.compute_s, pc.sync_s, objective,
                                         latency_bound_s)
            if best_key is None or key < best_key:
                best, best_key = plan, key
                best_bottleneck = pc.bottleneck_s
        assert best is not None
        return best, best_bottleneck
    best_cost = float("inf")
    for plan in gen:
        if not plan_feasible(graph, plan, tb.nodes):
            continue
        c = plan_cost(graph, plan, pf, tb)
        if c < best_cost:
            best, best_cost = plan, c
    assert best is not None
    return best, best_cost
