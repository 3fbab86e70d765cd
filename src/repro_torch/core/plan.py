"""Partition plans and their cost semantics.

A plan assigns every layer ``L_i`` a pair ``P_i = (p_i, t_i)`` (§3.3).  The
cost semantics shared by DPP and the engine:

* The plan decomposes into **segments** — maximal runs ``[a..b]`` with
  ``t_a .. t_{b-1} = NT`` and ``t_b = T`` (the last layer is always T,
  Algorithm 1 lines 11-12).
* Within a multi-layer segment every layer must use the *same spatial* scheme
  (halo-fused redundant compute is only meaningful when consecutive layers
  share a spatial split; OutC needs the full next-layer input, so OutC can
  never be in NT mode).
* Layer ``m`` of segment ``[a..b]`` computes an output enlarged by the
  receptive-field halo ``h_m`` (``graph.halo_growth``) — the redundant
  computation of §2.3.
* Each segment end pays the s-cost to re-layout its output into the next
  segment's scheme; the final layer pays a gather-to-root sync.

DAG graphs add junction rules on top (segments live *within* branches of
``ModelGraph.linearize()``):

* Fork layers (fan-out >= 2), merge layers (fan-in >= 2) and every branch
  tail are forced T-mode sync points — NT fusion never crosses a junction.
* A fork pays one s-cost per non-merge consumer (sequential broadcast).
* A merge pays the **max** over its incoming branch deliveries (the paper's
  branch transfers overlap; the slowest re-layout gates the merge).

A copy of the JAX package's ``core/plan.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from .cost import Testbed
from .estimator import CostEstimator
from .graph import LayerSpec, ModelGraph, halo_growth
from .partition import Mode, Scheme, min_shard_extent


@dataclasses.dataclass(frozen=True)
class Plan:
    """``steps[i] = (scheme, mode)`` for layer i (topological order)."""

    steps: Tuple[Tuple[Scheme, Mode], ...]

    def __post_init__(self) -> None:
        if self.steps and self.steps[-1][1] != Mode.T:
            raise ValueError("last layer must be in T mode")

    def __len__(self) -> int:
        return len(self.steps)

    def segments(self) -> List[Tuple[int, int]]:
        """Inclusive (start, end) of each T-terminated segment (chain
        interpretation; for branched graphs use per-branch segments)."""
        return steps_segments(self.steps)

    def validate(self) -> None:
        _validate_steps_slice(self.steps, where="segment")

    def validate_for(self, graph: ModelGraph) -> None:
        """Graph-aware validation: chain rules plus DAG junction rules."""
        if len(self.steps) != len(graph):
            raise ValueError("plan/graph length mismatch")
        if graph.is_chain:
            self.validate()
            return
        for i in range(len(graph)):
            if (graph.fan_in(i) >= 2 or graph.fan_out(i) >= 2) \
                    and self.steps[i][1] != Mode.T:
                raise ValueError(
                    f"junction layer {graph.layers[i].name} must be T-mode")
        for br in graph.linearize():
            sl = tuple(self.steps[i] for i in br.ids)
            if sl[-1][1] != Mode.T:
                raise ValueError(
                    f"branch tail {graph.layers[br.tail].name} must be "
                    f"T-mode (NT fusion cannot cross a junction)")
            _validate_steps_slice(sl, where=f"branch@{br.head}")


def steps_segments(steps: Sequence[Tuple[Scheme, Mode]]
                   ) -> List[Tuple[int, int]]:
    """Inclusive (start, end) segment spans of a step sequence."""
    segs, a = [], 0
    for i, (_, t) in enumerate(steps):
        if t == Mode.T:
            segs.append((a, i))
            a = i + 1
    return segs


def _validate_steps_slice(steps: Sequence[Tuple[Scheme, Mode]],
                          where: str) -> None:
    for a, b in steps_segments(steps):
        if b > a:
            schemes = {steps[m][0] for m in range(a, b + 1)}
            if len(schemes) != 1:
                raise ValueError(
                    f"{where} [{a},{b}] mixes schemes {schemes}")
            if not steps[a][0].spatial:
                raise ValueError(
                    f"{where} [{a},{b}] uses non-spatial scheme in NT mode")


@dataclasses.dataclass(frozen=True)
class PipelineCost:
    """Two-resource occupancy of one plan under pipelined execution.

    The simulator's resource model (``cluster.simsched``) has two resource
    classes: devices execute every compute stage, links carry every sync
    stage.  In a saturated pipeline each class processes its whole
    per-request workload back to back across overlapping requests, so the
    steady-state inter-departure time is the larger per-request occupancy —
    not the single-request latency, which pays both classes in series.

    ``compute_s`` sums the segment compute stages (straggler times, halos
    included); ``sync_s`` sums the sync stages (internal boundaries, fork
    deliveries, per-merge max over incoming deliveries, final gather).
    """

    compute_s: float
    sync_s: float

    @property
    def bottleneck_s(self) -> float:
        """Steady-state pipeline period: the busier resource class."""
        return max(self.compute_s, self.sync_s)

    @property
    def latency_s(self) -> float:
        """Single-request time: both classes in series (== plan_cost)."""
        return self.compute_s + self.sync_s

    @property
    def throughput_rps(self) -> float:
        t = self.bottleneck_s
        return 1.0 / t if t > 0.0 else float("inf")


def plan_pipeline_cost(graph: ModelGraph, plan: Plan, est: CostEstimator,
                       tb: Testbed) -> PipelineCost:
    """Pipelined cost of ``plan``: per-resource-class occupancy sums.

    Stage decomposition and estimator call pattern are identical to
    :func:`dag_plan_cost` (same segments, same s-queries, merge deliveries
    combine with max) — the two accumulators just land in separate buckets,
    so ``compute_s + sync_s`` equals the latency cost up to float
    association.
    """
    plan.validate_for(graph)
    layers = graph.layers
    compute = 0.0
    sync = 0.0
    merge_deliveries: Dict[int, List[float]] = {}
    for br in graph.linearize():
        ids = br.ids
        ls = [layers[i] for i in ids]
        steps = [plan.steps[i] for i in ids]
        for a, b in steps_segments(steps):
            scheme = steps[a][0]
            halos = halo_growth(ls[a:b + 1], b - a)
            for off, m in enumerate(range(a, b + 1)):
                compute += est.i_cost(ls[m], scheme, tb,
                                      extra_halo=halos[off] if b > a else 0)
            if b < len(ids) - 1:
                sync += est.s_cost(ls[b], ls[b + 1], scheme,
                                   steps[b + 1][0], tb)
        p_tail = steps[-1][0]
        consumers = graph.consumer_ids[ids[-1]]
        if not consumers:
            sync += est.s_cost(ls[-1], None, p_tail, None, tb)
        for c in consumers:
            d = est.s_cost(ls[-1], layers[c], p_tail, plan.steps[c][0], tb)
            if graph.fan_in(c) >= 2:
                merge_deliveries.setdefault(c, []).append(d)
            else:
                sync += d
    for ds in merge_deliveries.values():
        sync += max(ds)
    return PipelineCost(compute_s=compute, sync_s=sync)


def plan_stage_counts(graph: ModelGraph, plan: Plan) -> Tuple[int, int]:
    """``(compute_stages, sync_stages)`` of the plan's pipeline stage DAG.

    The shared stage-decomposition arithmetic: ``cluster.simsched`` builds
    exactly this many stages, and the engine's ``ExecStats`` reports the
    same compute-stage count from its executed segments — one contract
    across the analytic model, the simulator, and the real execution path.
    """
    plan.validate_for(graph)
    n_compute = 0
    n_sync = 0
    merges = set()
    for br in graph.linearize():
        ids = br.ids
        steps = [plan.steps[i] for i in ids]
        segs = steps_segments(steps)
        n_compute += len(segs)
        n_sync += len(segs) - 1          # internal boundaries
        consumers = graph.consumer_ids[ids[-1]]
        if not consumers:
            n_sync += 1                  # final gather
        for c in consumers:
            if graph.fan_in(c) >= 2:
                merges.add(c)            # one merge stage per merge layer
            else:
                n_sync += 1              # fork delivery
    return n_compute, n_sync + len(merges)


def plan_cost(graph: ModelGraph, plan: Plan, est: CostEstimator,
              tb: Testbed) -> float:
    """Total estimated inference time of ``plan`` (seconds).

    A chain is the single-branch special case of the DAG semantics (same
    segments, same estimator calls in the same order), so one evaluator
    serves both."""
    if len(plan) != len(graph):
        raise ValueError("plan/graph length mismatch")
    return dag_plan_cost(graph, plan, est, tb)


def dag_plan_cost(graph: ModelGraph, plan: Plan, est: CostEstimator,
                  tb: Testbed) -> float:
    """Plan cost for a branched graph: per-branch chain costs, plus fork
    broadcasts (summed) and merge deliveries (max over incoming branches).
    Reduces exactly to the chain semantics on a single-branch graph."""
    plan.validate_for(graph)
    layers = graph.layers
    total = 0.0
    merge_deliveries: Dict[int, List[float]] = {}
    for br in graph.linearize():
        ids = br.ids
        ls = [layers[i] for i in ids]
        steps = [plan.steps[i] for i in ids]
        for a, b in steps_segments(steps):
            scheme = steps[a][0]
            halos = halo_growth(ls[a:b + 1], b - a)
            for off, m in enumerate(range(a, b + 1)):
                total += est.i_cost(ls[m], scheme, tb,
                                    extra_halo=halos[off] if b > a else 0)
            if b < len(ids) - 1:   # boundary inside the branch
                total += est.s_cost(ls[b], ls[b + 1], scheme,
                                    steps[b + 1][0], tb)
        # crossing out of the branch tail
        p_tail = steps[-1][0]
        consumers = graph.consumer_ids[ids[-1]]
        if not consumers:   # graph output: gather to root
            total += est.s_cost(ls[-1], None, p_tail, None, tb)
        for c in consumers:
            d = est.s_cost(ls[-1], layers[c], p_tail, plan.steps[c][0], tb)
            if graph.fan_in(c) >= 2:
                merge_deliveries.setdefault(c, []).append(d)
            else:
                total += d
    for ds in merge_deliveries.values():
        total += max(ds)
    return total


def segment_halos(layers: Sequence[LayerSpec], a: int, b: int) -> List[int]:
    """Halo (extra output rows per side) for each layer of segment [a..b]."""
    return halo_growth(layers[a:b + 1], b - a)


def segment_feasible(layers: Sequence[LayerSpec], a: int, b: int,
                     scheme: Scheme, nodes: int) -> bool:
    """A multi-layer NT segment is feasible while its cumulative halo has not
    degenerated into full replication (the halo is monotone in segment
    length, so DPP prunes on the same rule)."""
    if b == a:
        return True
    if not scheme.spatial:
        return False
    halos = halo_growth(layers[a:b + 1], b - a)
    return 2 * halos[0] < min_shard_extent(layers[a], scheme, nodes)


def plan_feasible(graph: ModelGraph, plan: Plan, nodes: int) -> bool:
    if graph.is_chain:
        return all(segment_feasible(graph.layers, a, b, plan.steps[a][0],
                                    nodes)
                   for a, b in plan.segments())
    for br in graph.linearize():
        ls = [graph.layers[i] for i in br.ids]
        steps = [plan.steps[i] for i in br.ids]
        if not all(segment_feasible(ls, a, b, steps[a][0], nodes)
                   for a, b in steps_segments(steps)):
            return False
    return True


def fixed_plan(graph: ModelGraph, scheme: Scheme) -> Plan:
    return Plan(tuple((scheme, Mode.T) for _ in graph.layers))
