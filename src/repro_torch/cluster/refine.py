"""Simulator-in-the-loop plan refinement — close the loop between the
analytic pipelined-cost DP and the discrete-event schedule.

The analytic frontier scores a plan as ``(compute, sync)`` occupancy sums
built from per-stage straggler maxes and busiest-link bounds.  On
heterogeneous clusters and DAGs those are upper bounds: the straggler
device can differ per layer, parallel-branch transfers overlap on
different links, and the greedy schedule can hide more (or less) than the
two-class model assumes.  The simulator measures the truth: per-device
and per-link busy seconds of the actual pipelined schedule.

The key observation that makes refinement cheap: re-weighting the DP's
segment costs by a per-class factor (``beta`` on every i-cost, ``alpha``
on every s-cost) rescales the frontier axes but cannot change the
*nondominated set* — a pair dominated under one positive scaling is
dominated under all of them.  So the refinement loop never rebuilds
tables or re-runs the DP; it re-selects a point on the cached frontier
(built with ``prune_ub=False`` so the set is complete — the latency-
optimum cutoff ``plan_search`` uses is only exact for unscaled
selection):

1. pick the point minimizing ``max(beta*compute, alpha*sync)``
   (initially ``beta = alpha = 1``);
2. simulate its plan; measure per-request bottleneck occupancy of each
   resource class (``max_d device_busy / requests``, same for links);
3. set ``beta``/``alpha`` to the measured-over-analytic ratios and repeat
   until the selected point stops moving (a fixed point) or a selection
   repeats (a cycle — keep the simulator-best iterate).

A copy of the JAX package's ``cluster/refine.py`` without its tracing
hooks (metric gauges, flight-ring records and the oscillation postmortem
dump), which wait for the port's tracing package.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.core.dpp import Objective, PlanFrontier, pipeline_frontier
from repro_torch.core.graph import ModelGraph
from repro_torch.core.partition import ALL_SCHEMES, Scheme
from repro_torch.core.plan import Plan

from .estimator import ClusterAnalyticEstimator
from .simsched import SimReport, simulate
from .spec import ClusterSpec


class RefineOscillationError(RuntimeError):
    """The scaled re-selection entered a cycle (A -> B -> A -> ...)
    without reaching a fixed point: the measured occupancy ratios
    disagree with the analytic axes in a way no single ``(beta, alpha)``
    reweighting resolves.  Raised only under ``on_oscillation="raise"``;
    the default ``"best"`` accepts the simulator-best iterate instead."""


@dataclasses.dataclass(frozen=True)
class RefineStep:
    """One iterate: the frontier point tried and what the simulator saw."""

    point_idx: int
    compute_s: float          # analytic axis values of the tried point
    sync_s: float
    beta: float               # compute-axis weight used for this selection
    alpha: float              # sync-axis weight
    sim_throughput_rps: float
    sim_period_s: float       # 1 / throughput
    dev_occupancy_s: float    # measured max per-device busy per request
    link_occupancy_s: float   # measured max per-link busy per request


@dataclasses.dataclass(frozen=True)
class RefineResult:
    plan: Plan
    report: Optional[SimReport]  # simulator report of the returned plan
    #                              (None when occupancy came from real
    #                               measurements instead of the simulator)
    steps: Tuple[RefineStep, ...]
    converged: bool            # True when a selection fixed point was hit
    best_throughput_rps: float = 0.0

    @property
    def throughput_rps(self) -> float:
        return self.best_throughput_rps


def refine_with_simulator(graph: ModelGraph, cluster: ClusterSpec,
                          n_requests: int = 32, max_iters: int = 5,
                          weighted: bool = True,
                          schemes: Sequence[Scheme] = ALL_SCHEMES,
                          max_segment: int = 32,
                          allow_fusion: bool = True,
                          frontier: Optional[PlanFrontier] = None,
                          occupancy_fn: Optional[Callable[[Plan], object]]
                          = None,
                          rel_tol: Optional[float] = None,
                          on_oscillation: str = "best",
                          calibrator: Optional[object] = None
                          ) -> RefineResult:
    """Throughput plan with simulator-calibrated resource weights.

    Returns the simulator-best plan over all iterates (never worse than
    the unrefined ``Objective.THROUGHPUT`` plan, which is iterate 0).
    Pass ``frontier`` to reuse an already-built :class:`PlanFrontier`
    (build it with ``prune_ub=False`` if the scaled re-selection must be
    exact over the complete nondominated set; a pruned frontier still
    refines, just within the latency-optimum trust region).

    ``occupancy_fn`` replaces the simulator as the occupancy source with
    *real measurements*: called with each candidate plan, it must return
    an object with ``dev_occupancy_s`` / ``link_occupancy_s`` /
    ``period_s`` attributes — e.g. ``ExecStats.to_occupancy()`` from a
    warm instrumented mesh-executor run
    (``Session(..., ExecConfig(executor="mesh", instrument=True))``).
    The fixed-point loop is unchanged; only the measured-over-analytic
    ratios now come from the machine instead of the model, and the
    returned :class:`RefineResult` has ``report=None``.

    Termination: the loop runs at most ``max_iters`` simulations and
    stops early at a selection fixed point (``converged=True``), a
    selection cycle, or — with ``rel_tol`` set — as soon as the measured
    period moves by less than ``rel_tol`` relative to the previous
    iterate (near-stationary measurements on noisy occupancy sources
    would otherwise never repeat a selection exactly).
    ``on_oscillation="raise"`` turns a detected cycle into
    :class:`RefineOscillationError` instead of silently returning the
    simulator-best iterate.

    ``calibrator`` (a ``cluster.calibrate.OnlineCalibrator``) carries
    corrections *across* refinement calls: the loop warm-starts
    ``(beta, alpha)`` from ``calibrator.axis_scales()`` instead of
    ``(1, 1)`` and folds every *trusted* iterate back via
    ``calibrator.observe`` (untrusted samples never move the calibrator,
    matching the axis-weight rule below).

    Fault awareness: an ``occupancy_fn`` result with a nonzero
    ``failures`` attribute (``ExecStats.to_occupancy()`` sets it from the
    run's retry/timeout/fallback counters) is an *untrusted sample* — the
    step is recorded but the axis weights keep their previous values, so
    one faulty measurement cannot steer the selection, and a repeat
    selection off a faulty sample is not certified as ``converged``.
    """
    if on_oscillation not in ("best", "raise"):
        raise ValueError(f"on_oscillation {on_oscillation!r} not in "
                         f"('best', 'raise')")
    if rel_tol is not None and rel_tol < 0.0:
        raise ValueError(f"rel_tol must be >= 0, got {rel_tol}")
    est = ClusterAnalyticEstimator(cluster, weighted=weighted)
    fr = frontier if frontier is not None else pipeline_frontier(
        graph, est, cluster.compat_testbed(), schemes, max_segment,
        allow_fusion, prune_ub=False)

    beta = alpha = 1.0
    if calibrator is not None:
        beta, alpha = calibrator.axis_scales()
    seen: set = set()
    steps: List[RefineStep] = []
    best: Optional[Tuple[float, Plan, SimReport]] = None
    converged = False
    last_failed = False
    for _ in range(max_iters):
        idx = fr.select(Objective.THROUGHPUT, compute_scale=beta,
                        sync_scale=alpha)
        if idx in seen:
            fixed_point = len(steps) > 0 and idx == steps[-1].point_idx
            converged = fixed_point and not last_failed
            if not fixed_point and on_oscillation == "raise":
                cycle = [s.point_idx for s in steps] + [idx]
                raise RefineOscillationError(
                    f"refinement cycles over frontier points {cycle} "
                    f"without reaching a fixed point; pass "
                    f"on_oscillation='best' to accept the "
                    f"simulator-best iterate, or set rel_tol to accept "
                    f"near-stationary measurements as converged")
            break
        seen.add(idx)
        a = float(fr.points[idx, 0])
        b = float(fr.points[idx, 1])
        plan = fr.plan(idx)
        rep: Optional[SimReport] = None
        failed = False
        measured: object = None
        if occupancy_fn is not None:
            occ = occupancy_fn(plan)
            measured = occ
            period = float(occ.period_s)
            rps = 1.0 / period if period > 0.0 else 0.0
            dev_occ = float(occ.dev_occupancy_s)
            link_occ = float(occ.link_occupancy_s)
            failed = getattr(occ, "failures", 0) > 0
        else:
            rep = simulate(graph, plan, cluster, n_requests=n_requests,
                           weighted=weighted)
            rps = rep.throughput_rps
            # a degenerate report (zero or infinite throughput — e.g. an
            # all-zero-duration stage DAG) has no meaningful period; treat
            # it as an untrusted sample rather than dividing by it (the
            # historical ``1.0 / rps`` raised ZeroDivisionError on 0 and
            # poisoned the rel_tol check with inf)
            finite = 0.0 < rps < float("inf")
            period = 1.0 / rps if finite else 0.0
            failed = not finite
            measured = rep
            served = rep.n_requests
            dev_occ = max(rep.device_busy_s) / served
            link_occ = (max(rep.link_busy_s) / served
                        if rep.link_busy_s else 0.0)
        steps.append(RefineStep(
            point_idx=idx, compute_s=a, sync_s=b, beta=beta, alpha=alpha,
            sim_throughput_rps=rps, sim_period_s=period,
            dev_occupancy_s=dev_occ, link_occupancy_s=link_occ))
        # an untrusted sample may only seed best (the assert below needs
        # one iterate) — it never displaces a trusted one
        if best is None or (not failed and rps > best[0]):
            best = (rps, plan, rep)
        if failed:
            last_failed = True
            continue      # keep previous axis weights
        last_failed = False
        if calibrator is not None:
            calibrator.observe(graph, plan, measured, weighted=weighted)
        if rel_tol is not None and len(steps) >= 2:
            prev = steps[-2].sim_period_s
            if abs(period - prev) <= rel_tol * max(prev, 1e-30):
                converged = True
                break
        # measured-over-analytic occupancy ratios become the axis weights
        beta = dev_occ / a if a > 0.0 else 1.0
        alpha = link_occ / b if b > 0.0 else 1.0
    assert best is not None
    return RefineResult(plan=best[1], report=best[2],
                        steps=tuple(steps), converged=converged,
                        best_throughput_rps=best[0])
