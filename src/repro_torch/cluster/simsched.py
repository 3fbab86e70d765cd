"""Discrete-event execution simulator for plans on a cluster.

Executes a partition plan as a **pipelined multi-request schedule** over a
:class:`ClusterSpec`: every device runs a compute queue, every physical
link a transfer queue, and a greedy work-conserving scheduler (earlier
request first, then earlier stage) assigns tasks as resources free up.
Requests overlap — while request *r*'s boundary sync is in flight on the
links, the devices already start request *r+1*'s first segment — so the
simulator reports what the analytic per-request cost cannot: steady-state
throughput and the latency distribution under load (p50/p99).

The stage decomposition mirrors ``plan.dag_plan_cost`` exactly:

* one **compute stage** per T-terminated segment, with per-device
  durations summed layer by layer from the capability-weighted shard
  physics (``core.cost.hetero_device_times_s``, halos included);
* one **sync stage** per internal boundary / fork delivery / final gather,
  with per-link durations from the same byte-and-message model the
  analytic s-cost uses (``core.cost.sync_bytes_messages``), evaluated
  against each link's own bandwidth and latency;
* merge deliveries combine into a single stage whose per-link duration is
  the **max** over incoming branch deliveries — the analytic overlap
  semantics.

Because each stage maps one-to-one onto an analytic cost term, a
single-request run on a homogeneous cluster reproduces the analytic plan
cost (up to float summation order, ~1e-12 relative — tested); heterogeneous
or multi-request runs are the independent check the analytic model cannot
provide.

A copy of the JAX package's ``cluster/simsched.py``; its trace export
(:func:`export_sim_trace`, :func:`simulate_trace`) writes the schema of
``repro_torch.obs``, the one the mesh executor's traces use.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cost import hetero_device_times_s, sync_bytes_messages
from repro_torch.core.graph import ModelGraph, halo_growth
from repro_torch.core.plan import Plan, steps_segments
from repro_torch.cluster.spec import ClusterSpec


@dataclasses.dataclass(frozen=True)
class Stage:
    """One pipeline stage of a request: per-resource task durations."""

    kind: str                      # "compute" | "sync"
    durations: Tuple[float, ...]   # per-device (compute) or per-link (sync)
    deps: Tuple[int, ...]          # stage indices this stage waits on
    label: str


@dataclasses.dataclass(frozen=True)
class SimReport:
    """Result of one simulated schedule."""

    n_requests: int
    latencies_s: Tuple[float, ...]      # per request, arrival -> done
    makespan_s: float
    throughput_rps: float               # steady-state completions/second
    p50_latency_s: float
    #: conservative tail: the ``method="higher"`` order statistic (an
    #: observed latency), not a linear interpolation below it
    p99_latency_s: float
    device_busy_s: Tuple[float, ...]
    link_busy_s: Tuple[float, ...]
    #: with ``record_timeline=True``: per-task ``(resource, request,
    #: stage_idx, t_start_s, t_end_s)`` intervals (resource < n_dev is a
    #: device, the rest are links) — the raw material for
    #: :func:`export_sim_trace`
    timeline: Optional[Tuple[Tuple[int, int, int, float, float], ...]] \
        = dataclasses.field(default=None, compare=False)

    @property
    def device_utilization(self) -> Tuple[float, ...]:
        if self.makespan_s <= 0.0:
            return tuple(0.0 for _ in self.device_busy_s)
        return tuple(b / self.makespan_s for b in self.device_busy_s)


def _link_durations(cluster: ClusterSpec, bytes_busiest: float,
                    msgs: int) -> Tuple[float, ...]:
    """Per-link transfer seconds of one sync — ``Testbed.comm_time_s``
    evaluated against each link's own bandwidth/latency (the analytic
    busiest-link bound is the max of this vector when every link carries
    the pattern; contention across requests is the simulator's job)."""
    if bytes_busiest <= 0.0:
        return tuple(0.0 for _ in cluster.links)
    topo = cluster.compat_testbed().topo_factor()
    out = []
    for link in cluster.links:
        bw = link.bandwidth_gbps * 1e9 / 8.0
        out.append(bytes_busiest * topo / bw + msgs * link.latency_us * 1e-6)
    return tuple(out)


def build_stages(graph: ModelGraph, plan: Plan, cluster: ClusterSpec,
                 weighted: bool = True, batch_size: int = 1) -> List[Stage]:
    """Decompose ``plan`` into the per-request stage DAG (shared by every
    request; the scheduler instantiates it once per request).

    ``batch_size`` models request batching at the pipeline head: per-image
    compute and boundary byte volumes scale linearly with the batch, while
    per-message link latency does not (the amortization that makes batching
    win on latency-dominated links — see ``cluster.serving``)."""
    if batch_size < 1:
        raise ValueError("batch_size must be >= 1")
    plan.validate_for(graph)
    tb = cluster.compat_testbed()
    speeds = cluster.speeds_gflops
    derates = cluster.dev_derates
    weights = (cluster.capability_weights if weighted
               else (1.0,) * cluster.n)
    layers = graph.layers
    n = cluster.n

    stages: List[Stage] = []
    # merge head id -> (per-link max durations so far, producer stage deps)
    merge_acc: Dict[int, Tuple[np.ndarray, List[int]]] = {}
    # branch tail layer id -> its last compute stage index
    tail_stage: Dict[int, int] = {}
    # branch head layer id -> delivery/merge stage ids it must wait for
    entry_deps: Dict[int, List[int]] = {}

    def add(kind, durations, deps, label) -> int:
        stages.append(Stage(kind, tuple(float(d) for d in durations),
                            tuple(deps), label))
        return len(stages) - 1

    for br in graph.linearize():
        ids = br.ids
        ls = [layers[i] for i in ids]
        steps = [plan.steps[i] for i in ids]
        head = ids[0]

        deps = list(entry_deps.get(head, []))
        if head in merge_acc:
            durs, prods = merge_acc.pop(head)
            deps.append(add("sync", durs, prods,
                            f"merge->{layers[head].name}"))
        prev: Optional[int] = None
        for (a, b) in steps_segments(steps):
            scheme = steps[a][0]
            halos = halo_growth(ls[a:b + 1], b - a)
            dev = np.zeros(n, np.float64)
            for off, m in enumerate(range(a, b + 1)):
                dev += hetero_device_times_s(
                    ls[m], scheme, tb, speeds, derates, weights,
                    extra_halo=halos[off] if b > a else 0)
            seg_deps = deps if prev is None else [prev]
            prev = add("compute", dev * batch_size, seg_deps,
                       f"seg[{ls[a].name}..{ls[b].name}]")
            if b < len(ids) - 1:
                bb, msgs = sync_bytes_messages(ls[b], ls[b + 1], scheme,
                                               steps[b + 1][0], n)
                prev = add("sync",
                           _link_durations(cluster, bb * batch_size, msgs),
                           [prev], f"bound@{ls[b].name}")
        assert prev is not None
        tail_stage[ids[-1]] = prev

        p_tail = steps[-1][0]
        consumers = graph.consumer_ids[ids[-1]]
        if not consumers:
            bb, msgs = sync_bytes_messages(ls[-1], None, p_tail, None, n)
            add("sync", _link_durations(cluster, bb * batch_size, msgs),
                [prev], "gather")
        for c in consumers:
            bb, msgs = sync_bytes_messages(ls[-1], layers[c], p_tail,
                                           plan.steps[c][0], n)
            durs = np.asarray(_link_durations(cluster, bb * batch_size,
                                              msgs))
            if graph.fan_in(c) >= 2:
                acc = merge_acc.get(c)
                if acc is None:
                    merge_acc[c] = (durs, [prev])
                else:
                    merge_acc[c] = (np.maximum(acc[0], durs),
                                    acc[1] + [prev])
            else:
                entry_deps.setdefault(c, []).append(
                    add("sync", durs, [prev],
                        f"fork->{layers[c].name}"))
    return stages


def simulate(graph: ModelGraph, plan: Plan, cluster: ClusterSpec,
             n_requests: int = 1, arrival_period_s: float = 0.0,
             weighted: bool = True,
             warmup: Optional[int] = None,
             batch_size: int = 1,
             record_timeline: bool = False) -> SimReport:
    """Run ``n_requests`` through the plan's stage DAG on the cluster.

    ``arrival_period_s=0`` is the closed-loop saturation case (all requests
    queued at t=0); a positive period models an open arrival process.
    ``warmup`` requests (default ``n_requests // 4``) are dropped from the
    steady-state throughput estimate.  ``batch_size > 1`` treats each
    simulated request as a batch of that many user requests (compute and
    byte volumes scaled; reported latencies/throughput stay per *batch* —
    ``cluster.serving`` converts to per-request terms).
    ``record_timeline=True`` additionally captures every task's
    ``(resource, request, stage, start, end)`` interval in
    ``SimReport.timeline`` for trace export.
    """
    stages = build_stages(graph, plan, cluster, weighted=weighted,
                          batch_size=batch_size)
    n_stages = len(stages)
    n_dev = cluster.n
    n_link = len(cluster.links)
    n_res = n_dev + n_link

    # dependents[s] = stages waiting on s
    dependents: List[List[int]] = [[] for _ in range(n_stages)]
    for si, st in enumerate(stages):
        for d in st.deps:
            dependents[d].append(si)
    final_stage = n_stages - 1

    def resources(st: Stage) -> range:
        return (range(n_dev) if st.kind == "compute"
                else range(n_dev, n_dev + n_link))

    # per (request, stage): unmet dep count and unfinished task count
    dep_left = np.empty((n_requests, n_stages), np.int64)
    for si, st in enumerate(stages):
        dep_left[:, si] = len(st.deps)
    task_left = np.empty((n_requests, n_stages), np.int64)
    for si, st in enumerate(stages):
        task_left[:, si] = max(len(st.durations), 1)

    ready: List[List[Tuple[int, int, float]]] = [[] for _ in range(n_res)]
    busy = [False] * n_res
    busy_total = [0.0] * n_res
    done_t = np.full(n_requests, np.nan)
    events: List[Tuple[float, int, int, int, int, int]] = []
    seq = 0
    started: Dict[int, float] = {}           # resource -> task start time
    timeline: List[Tuple[int, int, int, float, float]] = []

    def stage_ready(t: float, r: int, si: int) -> None:
        st = stages[si]
        if not st.durations:     # degenerate (no links): completes in place
            stage_done(t, r, si)
            return
        for k, res in enumerate(resources(st)):
            heapq.heappush(ready[res], (r, si, st.durations[k]))

    def try_start(t: float, res: int) -> None:
        nonlocal seq
        if busy[res] or not ready[res]:
            return
        r, si, dur = heapq.heappop(ready[res])
        busy[res] = True
        busy_total[res] += dur
        if record_timeline:
            started[res] = t
        seq += 1
        heapq.heappush(events, (t + dur, seq, 1, res, r, si))

    def stage_done(t: float, r: int, si: int) -> None:
        if si == final_stage:
            done_t[r] = t
        for nxt in dependents[si]:
            dep_left[r, nxt] -= 1
            if dep_left[r, nxt] == 0:
                stage_ready(t, r, nxt)

    roots = [si for si, st in enumerate(stages) if not st.deps]
    for r in range(n_requests):
        seq += 1
        heapq.heappush(events,
                       (r * arrival_period_s, seq, 0, -1, r, -1))

    while events:
        t, _, kind, res, r, si = heapq.heappop(events)
        if kind == 0:            # arrival: root stages become ready
            for root in roots:
                stage_ready(t, r, root)
        else:                    # task finish
            busy[res] = False
            if record_timeline:
                timeline.append((res, r, si, started.pop(res), t))
            task_left[r, si] -= 1
            if task_left[r, si] == 0:
                stage_done(t, r, si)
        for rr in range(n_res):
            try_start(t, rr)

    assert not np.isnan(done_t).any(), "some requests never completed"
    arrivals = np.arange(n_requests) * arrival_period_s
    lat = done_t - arrivals
    makespan = float(done_t.max())
    order = np.sort(done_t)
    if n_requests == 1:
        thr = 1.0 / makespan if makespan > 0 else float("inf")
    else:
        w = n_requests // 4 if warmup is None else warmup
        w = min(max(w, 1), n_requests - 1)
        span = float(order[-1] - order[w - 1])
        thr = (n_requests - w) / span if span > 0 else float("inf")
    return SimReport(
        n_requests=n_requests,
        latencies_s=tuple(float(x) for x in lat),
        makespan_s=makespan,
        throughput_rps=float(thr),
        p50_latency_s=float(np.percentile(lat, 50)),
        # "higher" picks the first order statistic at or above the 99th
        # percentile — a latency a request actually saw.  The default
        # linear interpolation sits *below* the worst observation on small
        # samples, under-reporting the tail a p99 bound gates on.
        p99_latency_s=float(np.percentile(lat, 99, method="higher")),
        device_busy_s=tuple(busy_total[:n_dev]),
        link_busy_s=tuple(busy_total[n_dev:]),
        timeline=tuple(timeline) if record_timeline else None,
    )


def export_sim_trace(stages: List[Stage],
                     timeline: Tuple[Tuple[int, int, int, float, float],
                                     ...],
                     n_dev: int, process: str = "simulated",
                     pid: int = 2):
    """Render a recorded simulator timeline as an ``obs.trace.Tracer``
    in the **same schema the mesh executor emits**: one track per
    device (``dev0..``) plus one per link (``link0..``), every task a
    complete span named by its stage label with ``cat="stage"`` —
    so the predicted timeline and a measured mesh trace land in one
    Perfetto file and diff structurally (``obs.skew.diff_traces``)."""
    from repro_torch.obs.trace import STAGE_CAT, Tracer, device_track, \
        link_track
    tracer = Tracer(process=process, pid=pid)
    for d in range(n_dev):
        tracer.ensure_track(device_track(d))
    for res, r, si, t0, t1 in timeline:
        track = device_track(res) if res < n_dev \
            else link_track(res - n_dev)
        st = stages[si]
        tracer.add_complete(track, st.label, t0 * 1e6,
                            (t1 - t0) * 1e6, cat=STAGE_CAT,
                            args={"kind": st.kind, "request": r})
    return tracer


def simulate_trace(graph: ModelGraph, plan: Plan, cluster: ClusterSpec,
                   n_requests: int = 1, **kwargs):
    """Simulate and export the predicted timeline in one call:
    returns ``(SimReport, Tracer)`` (see :func:`export_sim_trace`)."""
    stages = build_stages(graph, plan, cluster,
                          weighted=kwargs.get("weighted", True),
                          batch_size=kwargs.get("batch_size", 1))
    rep = simulate(graph, plan, cluster, n_requests=n_requests,
                   record_timeline=True, **kwargs)
    return rep, export_sim_trace(stages, rep.timeline, cluster.n)
