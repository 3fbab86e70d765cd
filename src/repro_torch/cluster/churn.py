"""Fault injection for simsched — churn scenarios and strategy replay.

The counterpart of :mod:`cluster.elastic`: this module *produces* the
cluster events (device arrivals, departures, capability derates,
interconnect slowdowns) as seedable scenario timelines, and replays a
serving horizon under one of three replanning strategies:

* ``never`` — plan once at t=0, never react (the static-planner
  baseline: a crash of any plan member is a permanent outage);
* ``scratch`` — on every detected membership/capability change, rebuild
  the Pareto frontier from a cold planner and always cut over to the
  frontier optimum (correct but pays full re-registration wall time
  plus a drain+copy stall on every event);
* ``incremental`` — one persistent :class:`ElasticPlanner`: cached
  registrations / sync rows / frontiers are reused across events, and
  the keep-vs-migrate score can rationally leave a mildly degraded plan
  in place instead of stalling the fleet.

The replay is a discrete-event simulation at heartbeat resolution with
an explicit detection model: a crash is only *detected* after
``dead_misses`` missed heartbeats, a derate when the next heartbeat
carries the capability report — so time-to-recover honestly includes
detection delay + planner wall time + cutover (weight copy + in-flight
drain) stalls.  Serving rate between events comes from the closed-loop
:func:`cluster.simsched.simulate` throughput of the *current plan on the
true cluster state* — an undetected derate degrades the measured rate
before any planner notices.

Definitions used by the benchmark gates (the JAX package's
``benchmarks/churn_bench.py``):

* **goodput** — requests served over the whole horizon / horizon
  seconds, counting outage and cutover-stall windows at rate zero;
* **time-to-recover** — per injected fault (departure / leave / derate /
  slowdown): time from the true fault instant until the system is back
  in steady state — serving at a nonzero rate with no replan or
  migration pending.  A strategy that never reacts "recovers" instantly
  from a derate (it is steady, just degraded — the penalty shows up in
  goodput) but never recovers from a member crash (recovery = remaining
  horizon).

A copy of the JAX package's ``cluster/churn.py``.  Its scenario generators
draw the reference's events from the same seeds, faults included:
:func:`random_scenario` raises ``StopIteration`` on a seed whose timeline
lets a fresh device arrive, depart and arrive again (the re-arrival looks
it up in ``cluster.devices``, which never held it), as the reference does.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.dpp import Objective
from repro_torch.core.graph import ModelGraph
from repro_torch.core.plan import Plan
from repro_torch.obs import trace as _obs_trace

from .elastic import (CapacityError, DeviceRegistry, ElasticPlanner,
                      MembershipError)
from .simsched import simulate
from .spec import ClusterSpec, DeviceSpec

#: event kinds understood by the replayer
EVENT_KINDS = ("depart", "leave", "arrive", "derate", "slowdown", "recover")

#: replanning strategies understood by :func:`run_churn`
STRATEGIES = ("never", "scratch", "incremental")

#: fault kinds that open a time-to-recover measurement
FAULT_KINDS = ("depart", "leave", "derate", "slowdown")


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    """One injected cluster event at simulated time ``t``.

    ``depart`` — hard crash: the device stops serving *and* stops
    heartbeating at ``t`` (detected only after the lease expires).
    ``leave`` — graceful departure: announced, detected immediately.
    ``arrive`` — ``spec`` joins the fleet (detected at its first
    heartbeat).  ``derate`` — capability multiplier ``factor`` applied to
    ``device`` (reported with the next heartbeat).  ``slowdown`` —
    fleet-wide link bandwidth multiplier ``factor``.  ``recover`` —
    clears the device's derate (or the slowdown when ``device`` is None).
    """

    t: float
    kind: str
    device: Optional[str] = None
    factor: float = 1.0
    spec: Optional[DeviceSpec] = None

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown churn event kind {self.kind!r}")
        if self.kind == "arrive" and self.spec is None:
            raise ValueError("arrive events need a DeviceSpec")
        if self.kind in ("depart", "leave", "derate") and not self.device:
            raise ValueError(f"{self.kind} events need a device name")


@dataclasses.dataclass(frozen=True)
class ChurnScenario:
    name: str
    horizon_s: float
    events: Tuple[ChurnEvent, ...]

    def __post_init__(self):
        object.__setattr__(self, "events",
                           tuple(sorted(self.events, key=lambda e: e.t)))
        for e in self.events:
            if not (0.0 < e.t < self.horizon_s):
                raise ValueError(
                    f"event at t={e.t} outside (0, {self.horizon_s})")

    @property
    def n_departures(self) -> int:
        return sum(1 for e in self.events
                   if e.kind in ("depart", "leave"))


# ---------------------------------------------------------------------------
# scenario generators (seedable)
# ---------------------------------------------------------------------------

def scenario_mixed(cluster: ClusterSpec, seed: int = 0,
                   horizon_s: float = 40.0) -> ChurnScenario:
    """Derates + a link slowdown + one crash + a recovery: the general
    churn mix.  Derate targets/magnitudes are seeded; the crash victim is
    the last device (never the lead, so the survivor set stays planable
    on 2-device clusters)."""
    rng = np.random.default_rng(seed)
    names = [d.name for d in cluster.devices]
    d_derate = names[int(rng.integers(0, max(1, len(names) - 1)))]
    f1 = float(rng.uniform(0.4, 0.7))
    events = [
        ChurnEvent(t=horizon_s * 0.12, kind="derate", device=d_derate,
                   factor=f1),
        ChurnEvent(t=horizon_s * 0.30, kind="slowdown",
                   factor=float(rng.uniform(0.5, 0.8))),
        ChurnEvent(t=horizon_s * 0.45, kind="recover", device=d_derate),
        ChurnEvent(t=horizon_s * 0.55, kind="depart", device=names[-1]),
        ChurnEvent(t=horizon_s * 0.80, kind="recover"),
    ]
    return ChurnScenario(name=f"mixed-s{seed}", horizon_s=horizon_s,
                         events=tuple(events))


def scenario_flap(cluster: ClusterSpec, seed: int = 0,
                  horizon_s: float = 60.0) -> ChurnScenario:
    """One device repeatedly crashes and rejoins — the membership state
    sequence revisits itself, which is exactly what the incremental
    planner's frontier cache exploits."""
    rng = np.random.default_rng(seed)
    victim = cluster.devices[-1]
    jitter = float(rng.uniform(0.0, 0.02 * horizon_s))
    events = []
    for i, frac in enumerate((0.10, 0.40, 0.70)):
        t = horizon_s * frac + jitter
        events.append(ChurnEvent(t=t, kind="depart", device=victim.name))
        events.append(ChurnEvent(t=t + horizon_s * 0.15, kind="arrive",
                                 spec=victim))
    return ChurnScenario(name=f"flap-s{seed}", horizon_s=horizon_s,
                         events=tuple(events))


def scenario_crash_only(cluster: ClusterSpec, seed: int = 0,
                        horizon_s: float = 40.0) -> ChurnScenario:
    """Staggered hard crashes with no soft events — the pure outage
    case (needs >= 3 devices so one survives planning)."""
    rng = np.random.default_rng(seed)
    names = [d.name for d in cluster.devices]
    n_crash = min(2, len(names) - 1)
    victims = list(rng.choice(names[1:], size=n_crash, replace=False))
    events = [ChurnEvent(t=horizon_s * (0.25 + 0.35 * i), kind="depart",
                         device=str(v))
              for i, v in enumerate(victims)]
    return ChurnScenario(name=f"crash-s{seed}", horizon_s=horizon_s,
                         events=tuple(events))


CHURN_SCENARIOS: Dict[str, Callable[..., ChurnScenario]] = {
    "mixed": scenario_mixed,
    "flap": scenario_flap,
    "crash_only": scenario_crash_only,
}


def random_scenario(cluster: ClusterSpec, seed: int,
                    horizon_s: float = 40.0, n_events: int = 6,
                    ensure_departure: bool = True) -> ChurnScenario:
    """Seeded random churn timeline: arrival/departure/derate/slowdown
    processes with uniform event times.  At most ``n - 1`` distinct
    devices ever crash or leave, so the registry always keeps at least
    one live member; with ``ensure_departure`` the timeline contains at
    least one hard crash (the benchmark gate requires a real outage)."""
    rng = np.random.default_rng(seed)
    names = [d.name for d in cluster.devices]
    gone: set = set()
    events: List[ChurnEvent] = []
    times = np.sort(rng.uniform(0.05 * horizon_s, 0.95 * horizon_s,
                                size=n_events))
    fresh = itertools.count()
    for t in times:
        t = float(t)
        kind = str(rng.choice(["depart", "derate", "derate", "slowdown",
                               "arrive", "recover"]))
        if kind == "depart":
            alive = [n for n in names if n not in gone]
            if len(alive) <= 1:
                kind = "derate"
            else:
                victim = str(rng.choice(alive[1:]))
                gone.add(victim)
                events.append(ChurnEvent(t=t, kind="depart",
                                         device=victim))
                continue
        if kind == "arrive":
            if gone:
                back = sorted(gone)[0]
                gone.discard(back)
                spec = next(d for d in cluster.devices if d.name == back)
            else:
                spec = DeviceSpec(name=f"x{next(fresh)}",
                                  gflops=float(rng.uniform(4.0, 24.0)),
                                  mem_mb=1024)
                names.append(spec.name)
            events.append(ChurnEvent(t=t, kind="arrive", spec=spec))
            continue
        if kind == "derate":
            alive = [n for n in names if n not in gone]
            events.append(ChurnEvent(
                t=t, kind="derate", device=str(rng.choice(alive)),
                factor=float(rng.uniform(0.3, 0.9))))
            continue
        if kind == "slowdown":
            events.append(ChurnEvent(
                t=t, kind="slowdown",
                factor=float(rng.uniform(0.4, 0.9))))
            continue
        events.append(ChurnEvent(t=t, kind="recover",
                                 device=None))
    if ensure_departure and not any(e.kind in ("depart", "leave")
                                    for e in events):
        alive = [n for n in names if n not in gone]
        victim = alive[-1] if len(alive) > 1 else names[-1]
        events.append(ChurnEvent(t=float(0.5 * horizon_s), kind="depart",
                                 device=victim))
    return ChurnScenario(name=f"random-s{seed}", horizon_s=horizon_s,
                         events=tuple(events))


# ---------------------------------------------------------------------------
# strategy replay
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ChurnRunResult:
    """Outcome of replaying one scenario under one strategy."""

    strategy: str
    scenario: str
    horizon_s: float
    served_requests: float
    goodput_rps: float
    recoveries_s: Tuple[float, ...]       # one per injected fault
    mean_recovery_s: float
    max_recovery_s: float
    n_replans: int
    n_migrations: int                     # replans that changed the plan
    n_keeps: int                          # replans that kept the old plan
    plan_wall_total_s: float
    stall_total_s: float                  # cutover windows at rate zero
    reuse_counts: Dict[str, int]
    timeline: List[Dict]


def _fold_derate(spec: DeviceSpec, derate: float) -> DeviceSpec:
    if derate == 1.0:
        return spec
    return dataclasses.replace(spec,
                               eff_derate=spec.eff_derate * derate)


def run_churn(graph: ModelGraph, cluster: ClusterSpec,
              scenario: ChurnScenario, strategy: str, *,
              objective: Objective = Objective.THROUGHPUT,
              heartbeat_interval_s: float = 1.0, suspect_misses: int = 2,
              dead_misses: int = 3, horizon_requests: float = 300.0,
              inflight: int = 4, n_sim_requests: int = 12,
              weighted: bool = True, max_segment: int = 32,
              sim_cache: Optional[Dict] = None) -> ChurnRunResult:
    """Replay ``scenario`` on ``cluster`` under ``strategy`` (see module
    docstring for the strategies, the detection model, and the metric
    definitions)."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    hb = heartbeat_interval_s
    reg = DeviceRegistry.from_cluster(
        cluster, heartbeat_interval_s=hb, suspect_misses=suspect_misses,
        dead_misses=dead_misses)
    base_specs: Dict[str, DeviceSpec] = {d.name: d for d in cluster.devices}
    true_alive: Dict[str, bool] = {d.name: True for d in cluster.devices}
    true_derate: Dict[str, float] = {}
    true_link = 1.0
    sim_cache = {} if sim_cache is None else sim_cache

    def sim_rate(plan: Plan, plan_cluster: ClusterSpec) -> float:
        """Closed-loop throughput of ``plan`` on the TRUE capabilities of
        its device set (zero if any member is truly down)."""
        devs = []
        for d in plan_cluster.devices:
            if not true_alive.get(d.name, False):
                return 0.0
            devs.append(_fold_derate(base_specs[d.name],
                                     true_derate.get(d.name, 1.0)))
        links = tuple(dataclasses.replace(
            l, bandwidth_gbps=l.bandwidth_gbps * true_link)
            for l in plan_cluster.links)
        true_cl = dataclasses.replace(plan_cluster, devices=tuple(devs),
                                      links=links)
        key = (graph.name, plan.steps,
               ElasticPlanner.cluster_signature(true_cl, weighted),
               n_sim_requests)
        if key not in sim_cache:
            sim_cache[key] = simulate(
                graph, plan, true_cl,
                n_requests=n_sim_requests).throughput_rps
        return float(sim_cache[key])

    planner = ElasticPlanner(
        graph, weighted=weighted, max_segment=max_segment,
        horizon_requests=horizon_requests, inflight=inflight)
    plan_cluster = reg.cluster()
    d0 = planner.replan(plan_cluster, objective=objective)
    plan, cur_period = d0.plan, d0.period_s
    planned_sig = reg.signature()

    # -- event loop state --------------------------------------------------
    cur_t = 0.0
    served = 0.0
    stalled = False
    stall_total = 0.0
    rate = sim_rate(plan, plan_cluster)
    open_faults: List[float] = []
    recoveries: List[float] = []
    n_replans = n_migrations = n_keeps = 0
    wall_total = 0.0
    reuse_counts: Dict[str, int] = {
        "frontier_cache": 0, "registration": 0, "svals": 0, "rescale": 0,
        "suffix_reused_layers": 0, "branch_tables_reused": 0}
    timeline: List[Dict] = []
    pending_id = 0
    pending_live = False

    SEQ = itertools.count()
    heap: List[tuple] = []

    def push(t: float, kind: str, payload=None) -> None:
        heapq.heappush(heap, (t, next(SEQ), kind, payload))

    for e in scenario.events:
        push(e.t, "true", e)
    k = 1
    while k * hb <= scenario.horizon_s:
        push(k * hb, "tick", None)
        k += 1
    push(scenario.horizon_s, "end", None)

    def advance(to_t: float) -> None:
        nonlocal cur_t, served, stall_total
        dt = to_t - cur_t
        if dt > 0.0:
            eff = 0.0 if stalled else rate
            served += eff * dt
            if stalled:
                stall_total += dt
            cur_t = to_t

    def refresh_rate() -> None:
        nonlocal rate
        rate = sim_rate(plan, plan_cluster)
        # "never" is back in steady state as soon as it serves again; a
        # replanning strategy recovers only when its response deploys
        if (strategy == "never" and rate > 0.0 and not stalled
                and not pending_live):
            while open_faults:
                recoveries.append(cur_t - open_faults.pop())

    def begin_replan(now: float) -> None:
        """Plan for the newly detected cluster and schedule the cutover.
        Old plan keeps serving during the (off-critical-path) solve; the
        cutover itself is a stop-the-world stall of the migration time."""
        nonlocal n_replans, n_migrations, n_keeps, wall_total
        nonlocal pending_id, pending_live, stalled
        stalled = False      # a newer decision aborts a stale cutover
        try:
            det = reg.cluster()
        except MembershipError:
            return          # nothing live to plan on — faults stay open
        if strategy == "scratch":
            solver = ElasticPlanner(
                graph, weighted=weighted, max_segment=max_segment,
                horizon_requests=horizon_requests, inflight=inflight)
            dec = solver.replan(det, old_plan=plan,
                                old_cluster=plan_cluster,
                                objective=objective, consider_keep=False,
                                old_period_s=cur_period)
        else:
            dec = planner.replan(det, old_plan=plan,
                                 old_cluster=plan_cluster,
                                 objective=objective,
                                 old_period_s=cur_period)
        n_replans += 1
        wall_total += dec.plan_wall_s
        for key, val in dec.reuse.items():
            if key == "rescale":
                reuse_counts["rescale"] += int(val is not None)
            else:
                reuse_counts[key] += int(val)
        changed = dec.plan is not plan
        if changed:
            n_migrations += 1
        else:
            n_keeps += 1
        cutover = dec.migration.total_s if (changed
                                            or dec.migration.bytes_moved
                                            > 0.0) else 0.0
        pending_id += 1
        pending_live = True
        t_solved = now + dec.plan_wall_s
        if cutover > 0.0:
            push(t_solved, "stall_on", pending_id)
        push(t_solved + cutover, "deploy",
             (pending_id, dec.plan, det, changed, dec.period_s))
        timeline.append(dict(t=now, what="replan", strategy=strategy,
                             changed=changed, wall_s=dec.plan_wall_s,
                             cutover_s=cutover, reuse=dec.reuse))

    while heap:
        t, _, kind, payload = heapq.heappop(heap)
        t = min(t, scenario.horizon_s)
        advance(t)
        if kind == "end":
            break
        if kind == "true":
            e: ChurnEvent = payload
            if e.kind == "depart":
                true_alive[e.device] = False
            elif e.kind == "leave":
                true_alive[e.device] = False
                if e.device in {m.spec.name for m in reg.live_members()}:
                    reg.leave(e.device, now=t)
            elif e.kind == "arrive":
                base_specs[e.spec.name] = e.spec
                true_alive[e.spec.name] = True
                true_derate.pop(e.spec.name, None)
            elif e.kind == "derate":
                true_derate[e.device] = e.factor
            elif e.kind == "slowdown":
                true_link = e.factor
            elif e.kind == "recover":
                if e.device is not None:
                    true_derate.pop(e.device, None)
                else:
                    true_link = 1.0
            if e.kind in FAULT_KINDS:
                in_plan = any(d.name == e.device
                              for d in plan_cluster.devices)
                if e.kind in ("derate",) and not in_plan:
                    pass        # derating an unused device is a non-event
                elif strategy == "never" and e.kind in ("derate",
                                                        "slowdown"):
                    recoveries.append(0.0)   # steady (degraded) already
                else:
                    open_faults.append(t)
            refresh_rate()
            timeline.append(dict(t=t, what=f"true:{e.kind}",
                                 device=e.device, rate=rate))
        elif kind == "tick":
            for name, alive in true_alive.items():
                if not alive:
                    continue
                m = reg.get(name)
                if m is None or m.state.value in ("dead", "left"):
                    reg.join(base_specs[name], now=t)
                reg.heartbeat(name, now=t,
                              derate=true_derate.get(name, 1.0))
            reg.set_link_factor(true_link)
            reg.tick(now=t)
            try:
                sig = reg.signature()
            except MembershipError:
                sig = None
            if sig != planned_sig and strategy != "never":
                planned_sig = sig
                # detection instant: the membership/capability change
                # was noticed on this heartbeat tick (sim time in args)
                _obs_trace.instant(_obs_trace.PLANNER_TRACK, "detect",
                                   cat="planner", t_sim=t,
                                   strategy=strategy)
                begin_replan(t)
        elif kind == "stall_on":
            if payload == pending_id:
                stalled = True
        elif kind == "deploy":
            did, new_plan, new_cluster, changed, new_period = payload
            if did != pending_id:
                continue        # superseded by a newer replan
            plan, plan_cluster, cur_period = (new_plan, new_cluster,
                                              new_period)
            stalled = False
            pending_live = False
            refresh_rate()
            if rate > 0.0:
                while open_faults:
                    recoveries.append(t - open_faults.pop())
            timeline.append(dict(t=t, what="deploy", changed=changed,
                                 rate=rate))
    advance(scenario.horizon_s)
    while open_faults:
        recoveries.append(scenario.horizon_s - open_faults.pop())

    rec = tuple(recoveries)
    return ChurnRunResult(
        strategy=strategy, scenario=scenario.name,
        horizon_s=scenario.horizon_s, served_requests=served,
        goodput_rps=served / scenario.horizon_s,
        recoveries_s=rec,
        mean_recovery_s=float(np.mean(rec)) if rec else 0.0,
        max_recovery_s=float(np.max(rec)) if rec else 0.0,
        n_replans=n_replans, n_migrations=n_migrations, n_keeps=n_keeps,
        plan_wall_total_s=wall_total, stall_total_s=stall_total,
        reuse_counts=reuse_counts, timeline=timeline)


def compare_strategies(graph: ModelGraph, cluster: ClusterSpec,
                       scenario: ChurnScenario,
                       **kwargs) -> Dict[str, ChurnRunResult]:
    """All three strategies on one scenario, sharing the simulator
    memo (rates are modeling, not measurement — sharing is fair and
    keeps the sweep fast)."""
    sim_cache: Dict = {}
    return {s: run_churn(graph, cluster, scenario, s,
                         sim_cache=sim_cache, **kwargs)
            for s in STRATEGIES}
