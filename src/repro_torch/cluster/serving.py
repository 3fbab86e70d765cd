"""Request batching at the pipeline head — serving policy over the
discrete-event simulator.

The planner's throughput objectives fix the *plan*; this module fixes the
*operating point*: at a given request arrival rate, how many requests
should the pipeline head batch per inference pass?  Larger batches
amortize per-message link latency and raise pipeline capacity, but every
request in a batch waits for the batch to fill — the head-of-batch
request waits ``(batch-1)/rate`` before the pass even starts — so tail
latency pays for what throughput gains.

``sweep_serving`` runs the simulator's multi-request schedule across an
arrival-rate grid and a batch-size grid, scores each cell as *goodput*
(arrival rate served within the p99 bound, zero when the bound breaks or
the pipeline is unstable), and ``choose_batch`` picks the winning batch
size per rate.  Everything is simulator-measured — queueing delay under
the open arrival process is exactly what the analytic model cannot see.

A copy of the JAX package's ``cluster/serving.py``; ``plan_decode_serving``
plans over the port's ``runtime.decode`` graphs.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.graph import ModelGraph
from repro_torch.core.plan import Plan

from .simsched import simulate
from .spec import ClusterSpec


@dataclasses.dataclass(frozen=True)
class ServingPoint:
    """One (arrival rate, batch size) operating point, simulator-scored."""

    arrival_rate_rps: float
    batch_size: int
    capacity_rps: float        # closed-loop pipeline capacity at this batch
    stable: bool               # capacity >= arrival rate
    p50_latency_s: float       # per-request, batching wait included
    p99_latency_s: float
    goodput_rps: float         # rate served within the bound, else 0.0
    feasible: bool             # stable and p99 within bound


def serve_point(graph: ModelGraph, plan: Plan, cluster: ClusterSpec,
                arrival_rate_rps: float, batch_size: int,
                p99_bound_s: float, n_batches: int = 32,
                weighted: bool = True) -> ServingPoint:
    """Simulate one operating point.

    Batches of ``batch_size`` requests depart every ``batch/rate`` seconds
    (the fill time of an evenly-paced arrival stream); per-request latency
    adds the fill wait of the *first* request of the batch — the
    conservative (worst-member) accounting, which is what a p99 bound
    should see.  The p99 itself is conservative too: ``SimReport``
    reports the ``method="higher"`` order statistic, an observed latency
    rather than an interpolation below it.  Capacity comes from a
    closed-loop run of the same batched
    stage DAG; an unstable point (arrivals outrun capacity) is infeasible
    regardless of the simulated window.
    """
    if arrival_rate_rps <= 0.0:
        raise ValueError("arrival rate must be positive")
    cap = simulate(graph, plan, cluster, n_requests=max(8, n_batches // 2),
                   weighted=weighted, batch_size=batch_size)
    capacity_rps = cap.throughput_rps * batch_size
    stable = capacity_rps >= arrival_rate_rps * (1.0 - 1e-9)
    period = batch_size / arrival_rate_rps
    rep = simulate(graph, plan, cluster, n_requests=n_batches,
                   arrival_period_s=period, weighted=weighted,
                   batch_size=batch_size)
    fill_wait = (batch_size - 1) / arrival_rate_rps
    p50 = rep.p50_latency_s + fill_wait
    p99 = rep.p99_latency_s + fill_wait
    feasible = stable and p99 <= p99_bound_s
    return ServingPoint(
        arrival_rate_rps=arrival_rate_rps, batch_size=batch_size,
        capacity_rps=capacity_rps, stable=stable,
        p50_latency_s=p50, p99_latency_s=p99,
        goodput_rps=arrival_rate_rps if feasible else 0.0,
        feasible=feasible)


def choose_batch(graph: ModelGraph, plan: Plan, cluster: ClusterSpec,
                 arrival_rate_rps: float, p99_bound_s: float,
                 batch_sizes: Sequence[int] = (1, 2, 4, 8),
                 n_batches: int = 32,
                 weighted: bool = True
                 ) -> Tuple[ServingPoint, List[ServingPoint]]:
    """Best batch size at one arrival rate: max goodput, ties to the lower
    p99 (and then the smaller batch).  Returns ``(best, all_points)``;
    when no batch size meets the bound, ``best`` is the point closest to
    meeting it (min p99 among stable points, else max capacity)."""
    pts = [serve_point(graph, plan, cluster, arrival_rate_rps, b,
                       p99_bound_s, n_batches, weighted)
           for b in batch_sizes]
    feas = [p for p in pts if p.feasible]
    if feas:
        best = min(feas, key=lambda p: (-p.goodput_rps, p.p99_latency_s,
                                        p.batch_size))
    else:
        stable = [p for p in pts if p.stable]
        best = (min(stable, key=lambda p: (p.p99_latency_s, p.batch_size))
                if stable else
                max(pts, key=lambda p: (p.capacity_rps, -p.batch_size)))
    return best, pts


def sweep_serving(graph: ModelGraph, plan: Plan, cluster: ClusterSpec,
                  arrival_rates_rps: Sequence[float], p99_bound_s: float,
                  batch_sizes: Sequence[int] = (1, 2, 4, 8),
                  n_batches: int = 32,
                  weighted: bool = True) -> List[dict]:
    """Arrival-rate sweep: per rate, the chosen batch size and its scores
    (JSON-ready rows — the BENCH_serving record format)."""
    rows: List[dict] = []
    for rate in arrival_rates_rps:
        best, pts = choose_batch(graph, plan, cluster, rate, p99_bound_s,
                                 batch_sizes, n_batches, weighted)
        rows.append({
            "arrival_rate_rps": rate,
            "batch_size": best.batch_size,
            "goodput_rps": best.goodput_rps,
            "feasible": best.feasible,
            "capacity_rps": best.capacity_rps,
            "p50_ms": best.p50_latency_s * 1e3,
            "p99_ms": best.p99_latency_s * 1e3,
            "per_batch": {p.batch_size: {
                "goodput_rps": p.goodput_rps,
                "capacity_rps": p.capacity_rps,
                "p99_ms": p.p99_latency_s * 1e3,
                "stable": p.stable,
            } for p in pts},
        })
    return rows


@dataclasses.dataclass(frozen=True)
class DecodeServingReport:
    """Continuous-batching decode serving at one operating point."""

    prefill_s: float           # one prompt pass (planned prefill graph)
    decode_step_s: float       # one token step for the whole batch
    tokens_per_s: float        # generated tokens / makespan
    p50_latency_s: float       # per-request: arrival -> last token
    p99_latency_s: float
    mean_batch: float          # decode-batch occupancy over all steps
    makespan_s: float
    n_requests: int
    prefill_schemes: Tuple[str, ...]
    decode_schemes: Tuple[str, ...]


def plan_decode_serving(spec, cluster: ClusterSpec, prompt_len: int,
                        n_new: int, weighted: bool = True):
    """Split planning for autoregressive serving: one searched plan for
    the compute-bound prefill pass (``seq_len`` queries) and a separate
    one for the latency-bound decode step (one query against the full
    KV length).  The two phases have opposite arithmetic intensity, so a
    single plan systematically mis-serves one of them — this is the
    prefill/decode split every LLM-serving stack performs.  Returns the
    ``(prefill, decode)`` :class:`SearchResult` pair."""
    from repro_torch.cluster import cluster_plan_search
    from repro_torch.runtime.decode import decode_graph, prefill_graph
    pre = cluster_plan_search(prefill_graph(spec, prompt_len), cluster,
                              weighted=weighted)
    dec = cluster_plan_search(decode_graph(spec, prompt_len + n_new),
                              cluster, weighted=weighted)
    return pre, dec


def serve_decode(spec, cluster: ClusterSpec, *, prompt_len: int,
                 n_new: int, arrival_rate_rps: float, n_requests: int = 32,
                 max_batch: int = 8,
                 weighted: bool = True) -> DecodeServingReport:
    """Continuous decode-step batching over the prefill/decode split.

    Deterministic event loop (evenly-paced arrivals at
    ``arrival_rate_rps``): a request is prefilled as soon as the decode
    batch has a free slot — prefill blocks the batch for one
    ``prefill_s`` pass (prefill-priority admission) — then joins the
    running batch, where every decode step emits one token for *all*
    active requests and completed requests leave immediately.  This is
    the vLLM-style iteration-level scheduling policy: no request waits
    for a batch-mate to finish its full generation.  Step times come
    from the split plans of :func:`plan_decode_serving`; a decode step
    is priced independently of batch occupancy (decode is
    bandwidth-bound on the weights, which are read once per step
    regardless of batch size — the standard continuous-batching
    economy)."""
    if arrival_rate_rps <= 0.0:
        raise ValueError("arrival rate must be positive")
    if n_requests < 1 or n_new < 1 or max_batch < 1:
        raise ValueError(f"bad decode serving point: n_requests="
                         f"{n_requests}, n_new={n_new}, "
                         f"max_batch={max_batch}")
    pre, dec = plan_decode_serving(spec, cluster, prompt_len, n_new,
                                   weighted)
    prefill_s, decode_s = pre.cost, dec.cost
    arrivals = [i / arrival_rate_rps for i in range(n_requests)]
    waiting: List[int] = []
    active: dict = {}
    latencies = [0.0] * n_requests
    t, nxt, done, tokens = 0.0, 0, 0, 0
    occupancy: List[int] = []
    while done < n_requests:
        while nxt < n_requests and arrivals[nxt] <= t + 1e-12:
            waiting.append(nxt)
            nxt += 1
        if not active and not waiting:
            t = arrivals[nxt]           # idle until the next arrival
            continue
        if waiting and len(active) < max_batch:
            r = waiting.pop(0)
            t += prefill_s
            active[r] = n_new
            continue
        occupancy.append(len(active))
        t += decode_s
        tokens += len(active)
        for r in list(active):
            active[r] -= 1
            if active[r] == 0:
                del active[r]
                latencies[r] = t - arrivals[r]
                done += 1
    import numpy as np
    return DecodeServingReport(
        prefill_s=prefill_s, decode_step_s=decode_s,
        tokens_per_s=tokens / t,
        p50_latency_s=float(np.percentile(latencies, 50)),
        # conservative tail: an observed latency, never an interpolation
        # below the worst request (matches SimReport.p99_latency_s)
        p99_latency_s=float(np.percentile(latencies, 99, method="higher")),
        mean_batch=float(np.mean(occupancy)) if occupancy else 0.0,
        makespan_s=t, n_requests=n_requests,
        prefill_schemes=tuple(s.name for s, _ in pre.plan.steps),
        decode_schemes=tuple(s.name for s, _ in dec.plan.steps))


def max_goodput(graph: ModelGraph, plan: Plan, cluster: ClusterSpec,
                arrival_rates_rps: Sequence[float], p99_bound_s: float,
                batch_sizes: Sequence[int] = (1, 2, 4, 8),
                n_batches: int = 32,
                weighted: bool = True) -> Tuple[float, Optional[dict]]:
    """Highest feasible goodput across the rate grid (the serving-capacity
    headline number for one plan) and its sweep row."""
    rows = sweep_serving(graph, plan, cluster, arrival_rates_rps,
                         p99_bound_s, batch_sizes, n_batches, weighted)
    best_row = None
    best = 0.0
    for row in rows:
        if row["feasible"] and row["goodput_rps"] > best:
            best, best_row = row["goodput_rps"], row
    return best, best_row
