"""Elastic clusters — device membership, capability reports, and
incremental live replanning.

Production edge fleets are not static :class:`ClusterSpec` instances:
devices join, leave, throttle, and die mid-stream.  This module adds the
planner-side core:

* :class:`DeviceRegistry` — a membership layer keyed by
  :class:`DeviceSpec`: heartbeat/lease state machine
  (``JOINING → LIVE → SUSPECT → DEAD``, graceful ``LEFT``) with
  configurable miss thresholds, plus capability **derate reports**
  (a throttling device reports a multiplier on its effective capability
  with its heartbeat).  ``registry.cluster()`` projects the live
  membership onto a plain :class:`ClusterSpec`, so everything downstream
  (planner, simulator, executor) consumes ordinary cluster specs.
* :class:`ElasticPlanner` — incremental replanning on cluster events.
  Instead of re-solving the Pareto-frontier DP from scratch it reuses, in
  order of cheapness:

  1. **whole frontiers** for previously seen cluster states (flapping
     devices revisit states — an LRU keyed by the full capability
     signature);
  2. **the query registration** (`core.dpp.FrontierTables`) whenever the
     testbed projection (node count / topology / bottleneck link) is
     unchanged — the Python-heavy enumeration phase is skipped and only
     the numpy batch evaluation reruns;
  3. **sync-cost rows verbatim** across capability changes — s-costs read
     only the testbed projection, so a derate invalidates *only the
     i-rows* of the cached cost tables;
  4. **the entire cached frontier, rescaled**, when the new i-costs are a
     uniform positive multiple of the cached ones (per-axis positive
     rescaling cannot change a nondominated set) — zero DP work;
  5. **surviving suffix frontiers** of the chain DP / per-branch pinned
     tables of the DAG DP via ``FrontierTables.frontier(warm=True)``.

  On top of frontier selection the planner scores **plan migration** as
  an explicit term: moving to a new plan costs the weight bytes that must
  move between devices (scheme-aware ownership: spatial schemes
  replicate filters, OutC shards them) plus draining the requests in
  flight, amortized over an expected serving horizon — so it can
  rationally choose *keep the degraded plan* over *migrate to the new
  optimum*.  ``replan()`` returns the decision with both scores.

Memory feasibility is enforced plan-aware: :func:`plan_device_bytes`
computes each device's owned weight bytes + peak activation shard for a
*specific plan*, and the planner walks the frontier in objective order
until a fitting plan is found (:class:`CapacityError` when none fits).

A copy of the JAX package's ``cluster/elastic.py``, with its spans
(``replan.frontier``, ``replan.select``, ``replan.cutover``), metrics and
flight records in ``repro_torch.obs``.  ``ReplanDecision.plan_wall_s``
reads the host's wall clock, so two replays agree on it only under a
shared clock.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cost import Topology
from repro_torch.core.dpp import (FrontierTables, Objective, PlanFrontier,
                                  pipeline_objective_key)
from repro_torch.core.graph import ModelGraph
from repro_torch.core.partition import (ALL_SCHEMES, DTYPE_BYTES, Scheme,
                                        weighted_split_sizes)
from repro_torch.core.plan import Plan, plan_pipeline_cost
from repro_torch.obs import flight as _obs_flight
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace

from .estimator import ClusterAnalyticEstimator
from .spec import ClusterSpec, DeviceSpec, LinkSpec, topology_edges


class MembershipError(RuntimeError):
    """Raised on invalid registry transitions or an empty live set."""


class CapacityError(RuntimeError):
    """No frontier plan fits the surviving devices' memory."""


# ---------------------------------------------------------------------------
# membership state machine
# ---------------------------------------------------------------------------

class DeviceState(enum.Enum):
    JOINING = "joining"      # announced, no heartbeat yet
    LIVE = "live"            # heartbeating within the lease
    SUSPECT = "suspect"      # >= suspect_misses heartbeats missed
    DEAD = "dead"            # >= dead_misses missed — evicted from plans
    LEFT = "left"            # graceful departure


#: states whose devices still participate in plans (a SUSPECT device is
#: kept until the lease declares it DEAD — eviction is the disruptive act)
PLANNABLE_STATES = (DeviceState.LIVE, DeviceState.SUSPECT)


@dataclasses.dataclass
class Member:
    """One registered device and its lease/capability state."""

    spec: DeviceSpec
    state: DeviceState
    joined_at: float
    last_heartbeat: float
    derate: float = 1.0            # reported capability multiplier
    misses: int = 0

    def effective_spec(self) -> DeviceSpec:
        """The spec the planner sees: the reported derate folds into
        ``eff_derate`` (capability weights are ``gflops * eff_derate``)."""
        if self.derate == 1.0:
            return self.spec
        return dataclasses.replace(
            self.spec, eff_derate=self.spec.eff_derate * self.derate)


@dataclasses.dataclass(frozen=True)
class StateChange:
    """One registry transition, returned by the mutating calls."""

    name: str
    old: DeviceState
    new: DeviceState
    at: float


class DeviceRegistry:
    """Heartbeat/lease membership over :class:`DeviceSpec` entries.

    The registry is clock-agnostic: every call takes ``now`` explicitly,
    so simulated churn timelines and wall-clock deployments share one
    implementation.  A device misses a heartbeat when ``now`` advances
    ``heartbeat_interval_s`` past its last one; ``suspect_misses`` misses
    demote LIVE → SUSPECT (still planned), ``dead_misses`` misses evict
    (SUSPECT → DEAD — the disruptive transition callers replan on).
    """

    def __init__(self, link: LinkSpec = LinkSpec(),
                 topology: Topology = Topology.RING,
                 heartbeat_interval_s: float = 1.0,
                 suspect_misses: int = 2, dead_misses: int = 5,
                 name: str = "elastic",
                 _template: Optional[ClusterSpec] = None) -> None:
        if heartbeat_interval_s <= 0.0:
            raise ValueError("heartbeat_interval_s must be positive")
        if not (0 < suspect_misses <= dead_misses):
            raise ValueError("need 0 < suspect_misses <= dead_misses")
        self.link = link
        self.topology = topology
        self.heartbeat_interval_s = heartbeat_interval_s
        self.suspect_misses = suspect_misses
        self.dead_misses = dead_misses
        self.name = name
        self.link_factor = 1.0     # fleet-wide congestion multiplier
        self._members: "OrderedDict[str, Member]" = OrderedDict()
        self._template = _template
        self._version = 0

    # -- construction ------------------------------------------------------

    @classmethod
    def from_cluster(cls, cluster: ClusterSpec, now: float = 0.0,
                     **kwargs) -> "DeviceRegistry":
        """Seed a registry from a static cluster: every device joins LIVE
        at ``now``.  While the live membership equals the seed set, the
        seed's per-edge link graph is preserved (asymmetric presets keep
        their slow link); any membership change falls back to the uniform
        link template (the seed's bottleneck link)."""
        link = LinkSpec(bandwidth_gbps=cluster.bottleneck_bw_gbps,
                        latency_us=cluster.max_latency_us)
        reg = cls(link=link, topology=cluster.topology,
                  name=f"{cluster.name}-elastic", _template=cluster,
                  **kwargs)
        for d in cluster.devices:
            reg.join(d, now=now)
            reg.heartbeat(d.name, now=now)
        return reg

    # -- queries -----------------------------------------------------------

    def member(self, name: str) -> Member:
        m = self._members.get(name)
        if m is None:
            raise MembershipError(f"unknown device {name!r}")
        return m

    def get(self, name: str) -> Optional[Member]:
        """Like :meth:`member` but ``None`` for unknown names."""
        return self._members.get(name)

    def members(self) -> Tuple[Member, ...]:
        return tuple(self._members.values())

    def live_members(self) -> Tuple[Member, ...]:
        """Members in a plannable state, in join order."""
        return tuple(m for m in self._members.values()
                     if m.state in PLANNABLE_STATES)

    @property
    def version(self) -> int:
        """Monotone counter bumped on every observable change."""
        return self._version

    def signature(self) -> tuple:
        """Hashable capability state of the plannable membership — equal
        signatures produce equal ``cluster()`` projections (the elastic
        planner's frontier-cache key)."""
        return (tuple((m.spec, m.derate) for m in self.live_members()),
                self.link_factor, self.topology)

    def cluster(self) -> ClusterSpec:
        """Project the plannable membership onto a :class:`ClusterSpec`."""
        live = self.live_members()
        if not live:
            raise MembershipError("no live devices in the registry")
        devices = tuple(m.effective_spec() for m in live)
        template = self._template
        if (template is not None and self.link_factor == 1.0
                and devices == template.devices):
            return template
        link = LinkSpec(
            bandwidth_gbps=self.link.bandwidth_gbps * self.link_factor,
            latency_us=self.link.latency_us)
        n_edges = len(topology_edges(len(devices), self.topology))
        eff = {}
        if template is not None:
            eff = dict(eff_inh=template.eff_inh, eff_inw=template.eff_inw,
                       eff_outc=template.eff_outc,
                       eff_grid=template.eff_grid)
        return ClusterSpec(name=f"{self.name}-v{self._version}",
                           devices=devices, links=(link,) * n_edges,
                           topology=self.topology, **eff)

    # -- transitions -------------------------------------------------------

    def join(self, spec: DeviceSpec, now: float) -> StateChange:
        """Announce a device.  It stays JOINING (not planned) until its
        first heartbeat; a DEAD/LEFT name may rejoin with a fresh lease."""
        old = self._members.get(spec.name)
        if old is not None and old.state not in (DeviceState.DEAD,
                                                 DeviceState.LEFT):
            raise MembershipError(f"{spec.name!r} is already "
                                  f"{old.state.value}")
        prev = old.state if old is not None else DeviceState.LEFT
        self._members[spec.name] = Member(
            spec=spec, state=DeviceState.JOINING, joined_at=now,
            last_heartbeat=now)
        self._members.move_to_end(spec.name)
        self._version += 1
        return StateChange(spec.name, prev, DeviceState.JOINING, now)

    def leave(self, name: str, now: float) -> StateChange:
        """Graceful departure — immediate eviction, no lease wait."""
        m = self.member(name)
        old = m.state
        m.state = DeviceState.LEFT
        self._version += 1
        return StateChange(name, old, DeviceState.LEFT, now)

    def heartbeat(self, name: str, now: float,
                  derate: Optional[float] = None) -> Optional[StateChange]:
        """Record a heartbeat (optionally carrying a capability derate
        report).  JOINING/SUSPECT devices return to LIVE; DEAD/LEFT
        devices must :meth:`join` again first."""
        m = self.member(name)
        if m.state in (DeviceState.DEAD, DeviceState.LEFT):
            raise MembershipError(
                f"{name!r} is {m.state.value}; rejoin before heartbeating")
        m.last_heartbeat = now
        m.misses = 0
        change = None
        if m.state != DeviceState.LIVE:
            change = StateChange(name, m.state, DeviceState.LIVE, now)
            m.state = DeviceState.LIVE
            self._version += 1
        if derate is not None:
            self.report_derate(name, derate, now)
        return change

    def report_derate(self, name: str, derate: float, now: float) -> None:
        """Capability report: the device's effective throughput is
        ``derate`` times its spec (thermal throttling, co-tenant load).
        ``derate=1.0`` clears the report."""
        if derate <= 0.0:
            raise ValueError(f"derate must be positive, got {derate}")
        m = self.member(name)
        if m.derate != derate:
            m.derate = derate
            self._version += 1

    def set_link_factor(self, factor: float) -> None:
        """Fleet-wide interconnect congestion multiplier on bandwidth."""
        if factor <= 0.0:
            raise ValueError(f"link factor must be positive, got {factor}")
        if factor != self.link_factor:
            self.link_factor = factor
            self._version += 1

    def tick(self, now: float) -> List[StateChange]:
        """Advance the lease clock: count missed heartbeats and demote
        LIVE → SUSPECT → DEAD.  Returns the transitions (callers replan
        when any ``new == DEAD`` appears)."""
        changes: List[StateChange] = []
        for m in self._members.values():
            if m.state not in (DeviceState.LIVE, DeviceState.SUSPECT):
                continue
            m.misses = max(
                0, int((now - m.last_heartbeat)
                       / self.heartbeat_interval_s))
            want = m.state
            if m.misses >= self.dead_misses:
                want = DeviceState.DEAD
            elif m.misses >= self.suspect_misses:
                want = DeviceState.SUSPECT
            if want != m.state:
                changes.append(StateChange(m.spec.name, m.state, want, now))
                m.state = want
                self._version += 1
        return changes


# ---------------------------------------------------------------------------
# plan-aware memory + weight-ownership geometry
# ---------------------------------------------------------------------------

def _owned_intervals(layer, scheme: Scheme,
                     weights: Sequence[float]) -> List[Tuple[int, int]]:
    """Per-device owned interval of ``layer``'s out-channel axis under
    ``scheme``: spatial schemes replicate the full filter bank on every
    device, OutC shards it by capability share."""
    oc = layer.out_c
    if scheme == Scheme.OUTC:
        out = []
        at = 0
        for share in weighted_split_sizes(oc, list(weights)):
            out.append((at, at + share))
            at += share
        return out
    return [(0, oc)] * len(weights)


def plan_device_bytes(graph: ModelGraph, plan: Plan,
                      cluster: ClusterSpec) -> np.ndarray:
    """Per-device resident bytes of executing ``plan`` on ``cluster``:
    owned weight bytes (scheme-aware — spatial schemes replicate filters,
    OutC shards them by capability share) plus the peak activation shard
    (input + output feature maps of the heaviest layer).  The plan-aware
    counterpart of the advisory ``ClusterSpec.memory_ok``; NT halo
    overhang is ignored (it is bounded by the shard itself)."""
    n = cluster.n
    caps = list(cluster.capability_weights)
    w_owned = np.zeros(n)
    act_peak = np.zeros(n)
    for layer, (scheme, _mode) in zip(graph.layers, plan.steps):
        we = layer.weight_elems()
        oc = max(layer.out_c, 1)
        if we:
            per_ch = we * DTYPE_BYTES / oc
            w_owned += np.asarray(
                [(b - a) * per_ch
                 for a, b in _owned_intervals(layer, scheme, caps)])
        if scheme == Scheme.GRID2D:
            frac = np.full(n, 1.0 / n)
        elif scheme == Scheme.OUTC:
            frac = np.asarray(weighted_split_sizes(oc, caps)) / oc
        else:
            ext = layer.out_h if scheme == Scheme.INH else layer.out_w
            ext = max(ext, 1)
            frac = np.asarray(weighted_split_sizes(ext, caps)) / ext
        in_frac = np.ones(n) if scheme == Scheme.OUTC else frac
        act = (layer.in_elems() * in_frac
               + layer.out_elems() * frac) * DTYPE_BYTES
        act_peak = np.maximum(act_peak, act)
    return w_owned + act_peak


def plan_memory_ok(graph: ModelGraph, plan: Plan,
                   cluster: ClusterSpec) -> Tuple[bool, ...]:
    """Per-device fit of ``plan`` against ``mem_mb`` budgets."""
    need = plan_device_bytes(graph, plan, cluster)
    return tuple(float(b) <= d.mem_mb * 1e6
                 for b, d in zip(need, cluster.devices))


@dataclasses.dataclass(frozen=True)
class MigrationCost:
    """Cost of cutting the fleet over from one plan/cluster to another."""

    bytes_moved: float          # weight bytes that must travel
    move_s: float               # transfer time over the bottleneck link
    drain_s: float              # in-flight requests finishing on the old plan
    devices_touched: int        # devices receiving any bytes

    @property
    def total_s(self) -> float:
        return self.move_s + self.drain_s


def migration_cost_s(graph: ModelGraph, old_plan: Optional[Plan],
                     old_cluster: Optional[ClusterSpec], new_plan: Plan,
                     new_cluster: ClusterSpec, *, inflight: int = 0,
                     old_period_s: float = 0.0) -> MigrationCost:
    """Weight bytes to move + requests in flight drained — the explicit
    migration term of the elastic planner's keep-vs-migrate decision.

    Ownership is matched **by device name** across the old and new
    clusters: a surviving device only fetches the out-channel intervals
    it does not already hold (spatial schemes hold the full bank, so a
    spatial → spatial transition moves nothing on survivors); a new
    device fetches everything it owns.  ``old_plan=None`` (cold start)
    charges the full new footprint.  Transfer time is the moved bytes
    over the new cluster's bottleneck link plus one propagation latency
    per receiving device; drain time is ``inflight * old_period_s``.
    """
    caps_new = list(new_cluster.capability_weights)
    old_by_name: Dict[str, int] = {}
    caps_old: List[float] = []
    if old_plan is not None and old_cluster is not None:
        old_by_name = {d.name: i
                       for i, d in enumerate(old_cluster.devices)}
        caps_old = list(old_cluster.capability_weights)
    moved = np.zeros(new_cluster.n)
    for li, (layer, (scheme, _mode)) in enumerate(
            zip(graph.layers, new_plan.steps)):
        we = layer.weight_elems()
        if not we:
            continue
        oc = max(layer.out_c, 1)
        per_ch = we * DTYPE_BYTES / oc
        new_iv = _owned_intervals(layer, scheme, caps_new)
        old_iv = None
        if old_by_name:
            old_iv = _owned_intervals(
                layer, old_plan.steps[li][0], caps_old)
        for d, (a, b) in enumerate(new_iv):
            name = new_cluster.devices[d].name
            held = (0, 0)
            if old_iv is not None and name in old_by_name:
                held = old_iv[old_by_name[name]]
            overlap = max(0, min(b, held[1]) - max(a, held[0]))
            moved[d] += (b - a - overlap) * per_ch
    bytes_moved = float(moved.sum())
    touched = int(np.count_nonzero(moved))
    bw = new_cluster.bottleneck_bw_gbps * 1e9 / 8.0
    move_s = (bytes_moved / bw
              + touched * new_cluster.max_latency_us * 1e-6)
    drain_s = max(inflight, 0) * max(old_period_s, 0.0)
    return MigrationCost(bytes_moved=bytes_moved, move_s=move_s,
                         drain_s=drain_s, devices_touched=touched)


# ---------------------------------------------------------------------------
# incremental replanner
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReplanDecision:
    """Outcome of one :meth:`ElasticPlanner.replan` call."""

    plan: Plan
    migrate: bool               # False = keep the (degraded) current plan
    period_s: float             # analytic pipeline period of the choice
    score_s: float              # migration + horizon-amortized serving time
    migration: MigrationCost
    keep_score_s: Optional[float]   # score of the keep option (None if
    #                                 there was no current plan to keep)
    plan_wall_s: float          # planner wall time of this decision
    point_idx: Optional[int]    # frontier index (None when keeping)
    frontier: PlanFrontier
    reuse: Dict                 # which incremental reuse paths fired


class ElasticPlanner:
    """Incremental Pareto-frontier replanning over cluster events.

    One instance persists across events and owns the caches; see the
    module docstring for the reuse ladder.  ``replan(cluster, ...)``
    builds (or reuses) the frontier for the cluster, selects the
    objective-best **memory-feasible** point, scores it against keeping
    the current plan (migration + horizon amortization), and returns the
    rational choice.
    """

    def __init__(self, graph: ModelGraph, *, weighted: bool = True,
                 schemes: Sequence[Scheme] = ALL_SCHEMES,
                 max_segment: int = 32, allow_fusion: bool = True,
                 horizon_requests: float = 500.0, inflight: int = 4,
                 enforce_memory: bool = True, rescale_tol: float = 1e-9,
                 cache_size: int = 8) -> None:
        self.graph = graph
        self.weighted = weighted
        self.schemes = tuple(schemes)
        self.max_segment = max_segment
        self.allow_fusion = allow_fusion
        self.horizon_requests = horizon_requests
        self.inflight = inflight
        self.enforce_memory = enforce_memory
        self.rescale_tol = rescale_tol
        self.cache_size = cache_size
        # per testbed-projection: registration + last evaluated rows
        self._by_tb: "OrderedDict[tuple, Dict]" = OrderedDict()
        # whole-frontier LRU over full capability signatures (flapping)
        self._fr_cache: "OrderedDict[tuple, PlanFrontier]" = OrderedDict()
        self.replans = 0

    # -- caching -----------------------------------------------------------

    @staticmethod
    def cluster_signature(cluster: ClusterSpec, weighted: bool) -> tuple:
        return (cluster.devices, cluster.links, cluster.topology,
                cluster.eff_inh, cluster.eff_inw, cluster.eff_outc,
                cluster.eff_grid, weighted)

    def _lru_put(self, store: "OrderedDict", key, value) -> None:
        store[key] = value
        store.move_to_end(key)
        while len(store) > self.cache_size:
            store.popitem(last=False)

    def frontier_for(self, cluster: ClusterSpec
                     ) -> Tuple[PlanFrontier, Dict]:
        """The complete (``prune_ub=False``) frontier for ``cluster``,
        via the cheapest reuse path available.  Returns ``(frontier,
        reuse)`` where ``reuse`` records what fired."""
        reuse: Dict = {"frontier_cache": False, "registration": False,
                       "svals": False, "rescale": None,
                       "suffix_reused_layers": 0,
                       "branch_tables_reused": 0}
        sig = self.cluster_signature(cluster, self.weighted)
        hit = self._fr_cache.get(sig)
        if hit is not None:
            self._fr_cache.move_to_end(sig)
            reuse["frontier_cache"] = True
            return hit, reuse

        est = ClusterAnalyticEstimator(cluster, weighted=self.weighted)
        tb = cluster.compat_testbed()
        tb_key = (tb, self.weighted)
        entry = self._by_tb.get(tb_key)
        if entry is None:
            ft = FrontierTables.register(self.graph, est, tb, self.schemes,
                                         self.max_segment,
                                         self.allow_fusion)
            entry = {"ft": ft, "ivals": None, "svals": None,
                     "frontier": None}
            self._lru_put(self._by_tb, tb_key, entry)
        else:
            self._by_tb.move_to_end(tb_key)
            reuse["registration"] = True
        ft: FrontierTables = entry["ft"]

        # s-rows depend only on the testbed projection — reuse verbatim
        svals = entry["svals"]
        if svals is not None:
            reuse["svals"] = True
        ivals, svals = ft.evaluate(est=est, svals=svals)

        fr: Optional[PlanFrontier] = None
        prev_ivals = entry["ivals"]
        if (prev_ivals is not None and entry["frontier"] is not None
                and len(prev_ivals) == len(ivals) and len(ivals)):
            # uniform-rescale fast path: a capability change that scales
            # every i-cost by one factor scales the frontier's compute
            # axis without touching the nondominated set or its plans
            with np.errstate(divide="ignore", invalid="ignore"):
                ratio = np.asarray(ivals) / np.asarray(prev_ivals)
            finite = ratio[np.isfinite(ratio)]
            if len(finite):
                c = float(finite[0])
                if c > 0.0 and np.all(
                        np.abs(finite - c) <= self.rescale_tol * c):
                    old_fr: PlanFrontier = entry["frontier"]
                    fr = dataclasses.replace(
                        old_fr,
                        points=old_fr.points * np.asarray([c, 1.0]))
                    reuse["rescale"] = c
        if fr is None:
            fr = ft.frontier(ivals, svals, warm=True)
            reuse["suffix_reused_layers"] = \
                ft.last_reuse.get("suffix_reused_layers", 0)
            reuse["branch_tables_reused"] = \
                ft.last_reuse.get("branch_tables_reused", 0)
        entry["ivals"] = np.asarray(ivals)
        entry["svals"] = np.asarray(svals)
        entry["frontier"] = fr
        self._lru_put(self._fr_cache, sig, fr)
        return fr, reuse

    # -- selection ---------------------------------------------------------

    def _select_feasible(self, fr: PlanFrontier, cluster: ClusterSpec,
                         objective: Objective,
                         latency_bound_s: Optional[float]
                         ) -> Tuple[int, Plan]:
        """Best frontier point in objective order that fits the devices'
        memory (first point when ``enforce_memory`` is off) — plans are
        only materialised until one fits."""
        order = sorted(range(len(fr.points)), key=lambda i:
                       pipeline_objective_key(float(fr.points[i, 0]),
                                              float(fr.points[i, 1]),
                                              objective, latency_bound_s))
        for i in order:
            plan = fr.plan(i)
            if (not self.enforce_memory
                    or all(plan_memory_ok(self.graph, plan, cluster))):
                return i, plan
        raise CapacityError(
            f"{self.graph.name}: no frontier plan fits the "
            f"{cluster.n} surviving devices' memory budgets")

    def replan(self, cluster: ClusterSpec, old_plan: Optional[Plan] = None,
               old_cluster: Optional[ClusterSpec] = None, *,
               objective: Objective = Objective.THROUGHPUT,
               latency_bound_s: Optional[float] = None,
               old_period_s: Optional[float] = None,
               consider_keep: bool = True) -> ReplanDecision:
        """Plan for ``cluster``, rationally weighing migration from
        ``old_plan`` (on ``old_cluster``): each candidate is scored as
        ``migration_total_s + horizon_requests * period_s`` and the
        minimum wins — a mildly degraded plan whose migration would cost
        more than the horizon saves is *kept*.  With no ``old_plan`` the
        frontier optimum is adopted (cold start; migration charged from
        an empty fleet)."""
        t0 = time.perf_counter()
        self.replans += 1
        # replan breakdown spans (planner track): incremental frontier
        # build -> feasible selection -> cutover (migration) scoring
        with _obs_trace.span(_obs_trace.PLANNER_TRACK, "replan.frontier",
                             cat="planner", graph=self.graph.name,
                             devices=cluster.n) as sp:
            fr, reuse = self.frontier_for(cluster)
            sp.set(**{k: v for k, v in reuse.items() if k != "rescale"})
        _obs_metrics.inc("replan.count", graph=self.graph.name)
        for key, val in reuse.items():
            if key == "rescale":
                amt = 1.0 if val is not None else 0.0
            elif isinstance(val, bool):
                amt = 1.0 if val else 0.0
            else:
                amt = float(val)
            _obs_metrics.inc("replan.reuse", amt, path=key)
        est = ClusterAnalyticEstimator(cluster, weighted=self.weighted)
        tb = cluster.compat_testbed()
        with _obs_trace.span(_obs_trace.PLANNER_TRACK, "replan.select",
                             cat="planner"):
            best_i, best_plan = self._select_feasible(
                fr, cluster, objective, latency_bound_s)
        a, b = float(fr.points[best_i, 0]), float(fr.points[best_i, 1])
        best_period = max(a, b)

        with _obs_trace.span(_obs_trace.PLANNER_TRACK, "replan.cutover",
                             cat="planner"):
            keep_score: Optional[float] = None
            if old_plan is not None:
                # keep's period is re-costed on the NEW cluster — the
                # old plan now runs on derated/survivor capabilities,
                # not the rate it enjoyed when it was planned
                pc = plan_pipeline_cost(self.graph, old_plan, est, tb)
                keep_period = pc.bottleneck_s
                keep_mig = migration_cost_s(
                    self.graph, old_plan, old_cluster, old_plan, cluster,
                    inflight=0, old_period_s=0.0)
                keep_ok = (not self.enforce_memory
                           or all(plan_memory_ok(self.graph, old_plan,
                                                 cluster)))
                if keep_ok and consider_keep:
                    keep_score = (keep_mig.total_s
                                  + self.horizon_requests * keep_period)

            mig = migration_cost_s(
                self.graph, old_plan, old_cluster, best_plan, cluster,
                inflight=self.inflight,
                old_period_s=0.0 if old_period_s is None
                else old_period_s)
            move_score = mig.total_s + self.horizon_requests * best_period

        if (keep_score is not None and old_plan is not None
                and keep_score <= move_score):
            wall = time.perf_counter() - t0
            _obs_metrics.inc("replan.kept", graph=self.graph.name)
            _obs_flight.get_flight().record(
                "replan", graph=self.graph.name, kept=True,
                wall_s=wall, period_s=keep_period)
            return ReplanDecision(
                plan=old_plan, migrate=keep_mig.bytes_moved > 0.0,
                period_s=keep_period, score_s=keep_score,
                migration=keep_mig, keep_score_s=keep_score,
                plan_wall_s=wall, point_idx=None, frontier=fr,
                reuse=reuse)
        wall = time.perf_counter() - t0
        _obs_metrics.inc("replan.migrated", graph=self.graph.name)
        _obs_flight.get_flight().record(
            "replan", graph=self.graph.name, kept=False, wall_s=wall,
            period_s=best_period)
        return ReplanDecision(
            plan=best_plan, migrate=True, period_s=best_period,
            score_s=move_score, migration=mig, keep_score_s=keep_score,
            plan_wall_s=wall, point_idx=best_i, frontier=fr, reuse=reuse)
