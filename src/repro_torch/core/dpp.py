"""Dynamic Partition Planner — Algorithm 1 (§3.3), extended to DAGs.

Reverse-order DP over T-states.  ``S[i][p]`` is the optimal remaining time
from layer ``i`` to the end, given layer ``i``'s input is exactly sharded in
layout ``p``.  NT runs appear only *inside* segments ``[i..b]`` that start and
end at T boundaries — exactly the paper's Key designs 1-3: an NT-prefixed
subsequence has indeterminate workload (footnote 3), so such states are never
evaluated on their own.

Pruning (the paper's "piecing together" list):
  1. reverse search never expands NT-start states (they exist only inside
     segment enumeration);
  2. suffix costs ``S[b+1][p']`` are reused across all segments ending at b;
  3. dynamic threshold — segment cost is monotone in segment length, so the
     backtrack stops as soon as the partial segment cost alone exceeds the
     incumbent (and when the halo swallows the whole shard, at which point
     redundant compute has degenerated into full replication).

Branched graphs (fan-in/fan-out >= 2) run the same reverse DP **per branch**
of ``ModelGraph.linearize()`` and compose at junctions: branch tails and
junction layers are forced T-mode sync points, fork deliveries are summed,
and each merge pays the max over its incoming branch re-layouts (see
``plan.dag_plan_cost`` — the DP and the cost function share one semantics).
The junction skeleton must be a "ladder" — parallel branch bundles between
consecutive fork/merge points, which covers residual blocks and
Inception-style modules; arbitrary multi-source or nested-fork DAGs raise
``ValueError``.

Two drivers share that search structure:

* :func:`plan_search` — the production path.  Every i-/s-cost the DP can
  touch is precomputed through ``core.cost_tables`` in one batched
  ``i_cost_batch`` + one ``s_cost_batch`` estimator call, and the chain DP
  runs as numpy reductions over the scheme axis.
* :func:`plan_search_reference` — the scalar-call implementation, kept as
  the parity oracle and the path of scalar-only estimators.  The batched
  DP replicates the scalar tie-breaking (first minimum wins in ``b`` then
  ``q`` order), so both return the JAX package's plans and costs bit for
  bit.

The throughput objectives (``THROUGHPUT``, ``P99_BOUNDED``) run an exact
Pareto-frontier DP over (compute, sync) occupancy pairs from the same tables
(:func:`pipeline_frontier`), or from scalar-call providers for scalar-only
estimators.

A copy of the JAX package's ``core/dpp.py``, its tracing spans included:
with a tracer installed (``repro_torch.obs``) the search's table build, DP
sweep and reconstruction, and the frontier's register / evaluate / DP
phases, are ``cat="planner"`` spans on the planner track.
"""
from __future__ import annotations

import bisect
import dataclasses
import enum
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import trace as _obs_trace

from .cost import Testbed
from .cost_tables import (CostTableBuilder, pareto_front_2d, pareto_front_nd,
                          plan_chain_tables)
from .estimator import CostEstimator
from .graph import ModelGraph, halo_growth
from .partition import ALL_SCHEMES, Mode, Scheme, min_shard_extent
from .plan import Plan, PipelineCost

_INF = float("inf")


class Objective(enum.Enum):
    """What the planner optimizes for.

    * ``LATENCY`` — single-request inference time (the paper's objective):
      every compute and sync stage in series.
    * ``THROUGHPUT`` — steady-state pipelined serving rate: requests
      overlap, devices and links work concurrently, and the plan's period
      is the busier resource class (``PipelineCost.bottleneck_s``).
    * ``P99_BOUNDED`` — max throughput subject to an analytic
      single-request latency bound (``latency_bound_s``): the tail-latency
      proxy the serving layer refines with the simulator's real p99.
    """

    LATENCY = "latency"
    THROUGHPUT = "throughput"
    P99_BOUNDED = "p99_bounded"


def pipeline_objective_key(compute_s: float, sync_s: float,
                           objective: "Objective",
                           latency_bound_s: Optional[float] = None) -> tuple:
    """Total order over (compute, sync) cost pairs for one objective —
    shared by the DP's frontier selection and the exhaustive oracle, so
    both sides break ties identically.

    ``P99_BOUNDED`` sorts feasible plans (latency within the bound) before
    infeasible ones; when no plan is feasible both sides therefore degrade
    to the latency optimum."""
    mx = max(compute_s, sync_s)
    sm = compute_s + sync_s
    if objective == Objective.THROUGHPUT:
        return (mx, sm)
    if objective == Objective.P99_BOUNDED:
        if latency_bound_s is None:
            raise ValueError("P99_BOUNDED needs latency_bound_s")
        if sm <= latency_bound_s:
            return (0, mx, sm)
        return (1, sm, mx)
    return (sm, mx)


@dataclasses.dataclass
class SearchStats:
    i_calls: int = 0
    s_calls: int = 0
    states: int = 0
    pruned_threshold: int = 0
    pruned_halo: int = 0


@dataclasses.dataclass(frozen=True)
class SearchResult:
    plan: Plan
    cost: float
    stats: SearchStats
    #: objective the search optimized (LATENCY for the historical paths)
    objective: Objective = Objective.LATENCY
    #: per-resource-class occupancy of the plan (throughput objectives)
    pipeline: Optional[PipelineCost] = None


def plan_search(graph: ModelGraph, est: CostEstimator, tb: Testbed,
                schemes: Sequence[Scheme] = ALL_SCHEMES,
                max_segment: int = 32,
                allow_fusion: bool = True,
                objective: Objective = Objective.LATENCY,
                latency_bound_s: Optional[float] = None) -> SearchResult:
    """Run DPP from precomputed batched cost tables.  ``allow_fusion=False``
    restricts to all-T plans (the layerwise baseline); ``schemes``
    restricted to one scheme with fusion on gives the fused-layer baseline.
    Dispatches to the per-branch DAG composition when the graph is not a
    chain.  Under the default objective, returns the same plan and cost as
    :func:`plan_search_reference`, bit for bit.

    Throughput objectives (``THROUGHPUT``, ``P99_BOUNDED``) run the exact
    Pareto-frontier DP over (compute, sync) occupancy pairs from the same
    tables (see :func:`pipeline_frontier`); ``cost`` is then the pipeline
    bottleneck time and ``latency_bound_s`` feeds the P99 constraint.

    The batched tables assume the estimator is determined by the feature
    expression (the ``i_cost_batch`` contract).  Estimators that only
    implement the scalar protocol — e.g. oracles keyed on layer *names* —
    run scalar-call providers with identical search semantics."""
    if objective != Objective.LATENCY:
        fr = pipeline_frontier(graph, est, tb, schemes, max_segment,
                               allow_fusion)
        return fr.search_result(objective, latency_bound_s)
    if not hasattr(est, "i_cost_batch"):
        return plan_search_reference(graph, est, tb, schemes, max_segment,
                                     allow_fusion)
    if not graph.is_chain:
        return _dag_plan_search_batched(graph, est, tb, tuple(schemes),
                                        max_segment, allow_fusion)
    return _chain_plan_search_batched(graph, est, tb, tuple(schemes),
                                      max_segment, allow_fusion)


# ---------------------------------------------------------------------------
# Batched chain DP: numpy reductions over the (scheme x segment-length) axes.
# ---------------------------------------------------------------------------

def _chain_plan_search_batched(graph: ModelGraph, est: CostEstimator,
                               tb: Testbed, schemes: Tuple[Scheme, ...],
                               max_segment: int,
                               allow_fusion: bool) -> SearchResult:
    layers = graph.layers
    n = len(layers)
    k = len(schemes)

    registry = CostTableBuilder(est, tb)
    with _obs_trace.span(_obs_trace.PLANNER_TRACK,
                         "plan_search.table_build", cat="planner",
                         graph=graph.name, layers=n) as _sp:
        fin = plan_chain_tables(layers, registry, schemes, max_segment,
                                allow_fusion, tb.nodes, with_final=True)
        tbl = fin(*registry.evaluate())
        _sp.set(i_rows=registry.i_entries, s_rows=registry.s_entries)
    seg = tbl.seg                        # (n, k, cap), +inf = inadmissible
    cap = seg.shape[2]

    with _obs_trace.span(_obs_trace.PLANNER_TRACK,
                         "plan_search.dp_sweep", cat="planner",
                         graph=graph.name):
        S = np.full((n + 1, k), _INF)
        choice_b = np.full((n, k), -1, np.int64)
        choice_q = np.full((n, k), -1, np.int64)
        ks = np.arange(k)
        for i in range(n - 1, -1, -1):
            m = min(cap, n - i)
            # cand[p, L, q] = (seg + boundary s-cost) + suffix — the
            # same float association as the scalar reference, so costs
            # stay bit-identical
            cand = np.full((k, m, k), _INF)
            Lf = n - 1 - i                  # L index of a final segment
            if Lf < m:
                cand[:, Lf, 0] = seg[i, :, Lf] + tbl.s_final
            mn = min(m, Lf)                 # segments with a next layer
            if mn > 0:
                sb = tbl.sbound[i:i + mn].transpose(1, 0, 2)  # (p, L, q)
                cand[:, :mn, :] = (seg[i, :, :mn, None] + sb) \
                    + S[i + 1:i + 1 + mn][None, :, :]
            flat = cand.reshape(k, m * k)
            fi = np.argmin(flat, axis=1)    # first min: b-major, q-minor
            S[i] = flat[ks, fi]             # — the scalar scan order
            Lb = fi // k
            choice_b[i] = i + Lb
            choice_q[i] = np.where(Lb == Lf, -1, fi % k)

        pi = int(np.argmin(S[0]))
        total = float(S[0][pi])

    with _obs_trace.span(_obs_trace.PLANNER_TRACK,
                         "plan_search.reconstruct", cat="planner",
                         graph=graph.name):
        steps: List[Tuple[Scheme, Mode]] = []
        i = 0
        while i < n:
            b, qi = int(choice_b[i][pi]), int(choice_q[i][pi])
            p = schemes[pi]
            for m2 in range(i, b + 1):
                steps.append((p, Mode.NT if m2 < b else Mode.T))
            i = b + 1
            if qi >= 0:
                pi = qi

    stats = SearchStats(
        i_calls=registry.i_entries, s_calls=registry.s_entries,
        states=n * k, pruned_halo=tbl.halo_cuts,
        pruned_threshold=_threshold_prunes(seg, S[:n]))
    return SearchResult(plan=Plan(tuple(steps)), cost=total, stats=stats)


def _threshold_prunes(seg: np.ndarray, S: np.ndarray) -> int:
    """Dynamic-threshold prune counter, derived from the table masks: a
    state (i, p) counts as pruned when some admissible segment's i-cost
    alone already reaches the state's optimal remaining time — exactly the
    candidates the scalar backtrack refuses to extend."""
    with np.errstate(invalid="ignore"):
        hit = (seg != _INF) & (seg >= S[:, :, None]) & \
            np.isfinite(S[:, :, None])
    return int(hit.any(axis=2).sum())


# ---------------------------------------------------------------------------
# Shared per-branch chain DP with pinned boundary layouts (used by both the
# batched and reference DAG drivers — only the cost lookups differ).
# ---------------------------------------------------------------------------

def _pinned_chain_dp(n: int, schemes: Tuple[Scheme, ...],
                     seg_costs: Callable[[int, int], List[Tuple[int, float]]],
                     bound_cost: Callable[[int, int, int], float],
                     stats: SearchStats) -> Dict[Tuple[int, int],
                                                 Tuple[float, tuple]]:
    """Reverse DP over one branch with pinned boundary layouts.

    Returns ``{(head_idx, tail_idx): (cost, steps)}`` — the minimal
    *internal* cost of the branch (i-costs with halos + s-costs at internal
    T boundaries; no entry delivery, no exit delivery/gather) with the first
    segment using ``schemes[head_idx]`` and the last ``schemes[tail_idx]``.
    ``seg_costs(i, pi)`` yields the admissible ``(b, segcost)`` options in
    ascending ``b`` order (already reflecting any head pinning).
    """
    k = len(schemes)
    tables: Dict[Tuple[int, int], Tuple[float, tuple]] = {}
    for ti in range(k):
        S = [[_INF] * k for _ in range(n)]
        choice = [[(-1, -1)] * k for _ in range(n)]
        for i in range(n - 1, -1, -1):
            for pi in range(k):
                best, best_choice = _INF, (-1, -1)
                stats.states += 1
                for b, segcost in seg_costs(i, pi):
                    if segcost >= best:
                        stats.pruned_threshold += 1
                        break
                    if b == n - 1:
                        if pi == ti and segcost < best:
                            best, best_choice = segcost, (b, -1)
                    else:
                        for qi in range(k):
                            if S[b + 1][qi] == _INF:
                                continue
                            c = (segcost + bound_cost(b, pi, qi)
                                 + S[b + 1][qi])
                            if c < best:
                                best, best_choice = c, (b, qi)
                S[i][pi] = best
                choice[i][pi] = best_choice
        for pi in range(k):
            if S[0][pi] == _INF:
                continue
            steps: List[Tuple[Scheme, Mode]] = []
            i, cp = 0, pi
            while i < n:
                b, qi = choice[i][cp]
                p = schemes[cp]
                for m in range(i, b + 1):
                    steps.append((p, Mode.NT if m < b else Mode.T))
                i = b + 1
                if qi >= 0:
                    cp = qi
            tables[(pi, ti)] = (S[0][pi], tuple(steps))
    return tables


def _scalar_chain_tables(ls, icost, scost, schemes, max_segment,
                         allow_fusion, head_solo, nodes, stats):
    """Reference (scalar-call) segment/boundary providers + pinned DP."""
    seg_costs, bound_cost = _scalar_chain_providers(
        ls, icost, scost, schemes, max_segment, allow_fusion, head_solo,
        nodes, stats)
    return _pinned_chain_dp(len(ls), schemes, seg_costs, bound_cost, stats)


def _scalar_chain_providers(ls, icost, scost, schemes, max_segment,
                            allow_fusion, head_solo, nodes, stats):
    """Scalar-call ``(seg_costs, bound_cost)`` providers of one chain —
    the per-query counterpart of :class:`ChainTables` (same admissibility
    rules, same scalar accumulation order), shared by the reference DP and
    the scalar-estimator frontier paths."""
    n = len(ls)

    # Segment and boundary costs are identical across the k tail pins, so
    # compute each once (lazily) and share them between the per-tail DPs.
    seg_cache: Dict[Tuple[int, int], List[Tuple[int, float]]] = {}
    bound_cache: Dict[Tuple[int, int, int], float] = {}

    def seg_costs(i: int, pi: int) -> List[Tuple[int, float]]:
        hit = seg_cache.get((i, pi))
        if hit is not None:
            return hit
        p = schemes[pi]
        out: List[Tuple[int, float]] = []
        seg_hi = min(i + max_segment, n) if allow_fusion else i + 1
        if head_solo and i == 0:
            seg_hi = i + 1
        for b in range(i, seg_hi):
            if b > i and not p.spatial:
                break
            halos = halo_growth(ls[i:b + 1], b - i)
            if b > i and 2 * halos[0] >= min_shard_extent(ls[i], p, nodes):
                stats.pruned_halo += 1
                break
            segcost = 0.0
            for off, m in enumerate(range(i, b + 1)):
                segcost += icost(ls[m], p, halos[off] if b > i else 0)
            out.append((b, segcost))
        seg_cache[(i, pi)] = out
        return out

    def bound_cost(b: int, pi: int, qi: int) -> float:
        key = (b, pi, qi)
        hit = bound_cache.get(key)
        if hit is None:
            hit = scost(ls[b], ls[b + 1], schemes[pi], schemes[qi])
            bound_cache[key] = hit
        return hit

    return seg_costs, bound_cost


# ---------------------------------------------------------------------------
# DAG composition: per-branch chain tables + ladder DP over junctions.
# ---------------------------------------------------------------------------

def _ladder(graph: ModelGraph):
    """Condense the DAG's branches into a spine with parallel bundles.

    Returns ``(branches, spine, bundles)`` where ``spine`` is a list of
    branch indices and ``bundles[t] = (interior_branch_ids, n_direct)``
    describes the parallel branches (plus identity skip edges) between
    ``spine[t]``'s tail (the fork) and ``spine[t+1]``'s head (the merge).
    """
    branches = graph.linearize()
    n_br = len(branches)
    bidx: Dict[int, int] = {}
    for t, br in enumerate(branches):
        for i in br.ids:
            bidx[i] = t
    preds: List[set] = [set() for _ in range(n_br)]
    succs: List[set] = [set() for _ in range(n_br)]
    for i, prods in enumerate(graph.producer_ids):
        for j in prods:
            if j >= 0 and bidx[j] != bidx[i]:
                preds[bidx[i]].add(bidx[j])
                succs[bidx[j]].add(bidx[i])
    sources = [t for t in range(n_br) if not preds[t]]
    if len(sources) != 1:
        raise ValueError(
            f"{graph.name}: plan_search needs a single-source DAG "
            f"(got {len(sources)} source branches)")
    spine = [sources[0]]
    bundles: List[Tuple[List[int], int]] = []
    cur = sources[0]
    used = {cur}
    while succs[cur]:
        interior: List[int] = []
        merges: set = set()
        for b in sorted(succs[cur]):
            if graph.fan_in(branches[b].head) >= 2:
                merges.add(b)
            else:
                interior.append(b)
        for b in interior:
            if preds[b] != {cur} or len(succs[b]) != 1:
                raise ValueError(
                    f"{graph.name}: nested fork at branch {b} — only "
                    f"fork -> parallel branches -> merge ladders are "
                    f"supported by plan_search")
            merges.update(succs[b])
        if len(merges) != 1:
            raise ValueError(
                f"{graph.name}: branches from {branches[cur].tail} do not "
                f"reconverge at a single merge — not a ladder DAG")
        nxt = merges.pop()
        if not preds[nxt] <= set(interior) | {cur}:
            raise ValueError(
                f"{graph.name}: merge at layer "
                f"{graph.layers[branches[nxt].head].name} has inputs from "
                f"outside its bundle — not a ladder DAG")
        n_direct = sum(1 for j in graph.producer_ids[branches[nxt].head]
                       if j == branches[cur].tail)
        bundles.append((interior, n_direct))
        spine.append(nxt)
        used.add(nxt)
        used.update(interior)
        cur = nxt
    if len(used) != n_br:
        raise ValueError(f"{graph.name}: {n_br - len(used)} branches are "
                         f"unreachable along the ladder — unsupported DAG")
    return branches, spine, bundles


def _dag_compose(graph: ModelGraph, schemes: Tuple[Scheme, ...],
                 btable: Callable[[int, bool], Dict],
                 jscost: Callable[[int, Optional[int], int, Optional[int]],
                                  float],
                 stats: SearchStats) -> SearchResult:
    """Ladder DP over junctions.  ``btable(branch, head_solo)`` returns the
    pinned chain tables of one branch; ``jscost(prod_id, cons_id, pi, qi)``
    the junction delivery s-cost (``cons_id=None``/``qi=None`` is the final
    gather)."""
    branches, spine, bundles = _ladder(graph)
    layers = graph.layers
    k = len(schemes)
    K = len(spine)

    spine_tab = [btable(s, idx > 0) for idx, s in enumerate(spine)]
    interior_tab = {b: btable(b, False)
                    for ints, _ in bundles for b in ints}

    # min over head schemes of (fork delivery + branch internal cost), per
    # (fork tail scheme, branch tail scheme)
    ib_memo: Dict[Tuple[int, int, int], Tuple[float, int]] = {}

    def ib_entry(b: int, qf_i: int, pt_i: int) -> Tuple[float, int]:
        key = (b, qf_i, pt_i)
        hit = ib_memo.get(key)
        if hit is not None:
            return hit
        fork_id = graph.producer_ids[branches[b].head][0]
        head_id = branches[b].head
        best: Tuple[float, int] = (_INF, -1)
        for ph_i in range(k):
            e = interior_tab[b].get((ph_i, pt_i))
            if e is None:
                continue
            c = jscost(fork_id, head_id, qf_i, ph_i) + e[0]
            if c < best[0]:
                best = (c, ph_i)
        ib_memo[key] = best
        return best

    bundle_memo: Dict[Tuple[int, int, int], Tuple[float, Optional[list]]] = {}

    def bundle_solve(t: int, pt_i: int, qm_i: int):
        """Min cost of delivering the bundle between spine t and t+1, given
        the fork tail scheme and merge head scheme.  Per-branch internal and
        fork-delivery costs sum; merge deliveries combine with max.  Exact:
        enumerate which delivery attains the max, pin it, and let every
        other branch independently take its cheapest option whose delivery
        fits under it.

        The candidate scan is vectorized over the (branch x tail-scheme)
        option tables: one (candidate, branch, scheme) feasibility tensor,
        first-min reductions matching the scalar tie-breaking, and a
        branch-ordered accumulation that keeps totals bit-identical to the
        per-candidate loop."""
        key = (t, pt_i, qm_i)
        hit = bundle_memo.get(key)
        if hit is not None:
            return hit
        ints, n_direct = bundles[t]
        fork_id = branches[spine[t]].tail
        merge_id = branches[spine[t + 1]].head
        d0 = jscost(fork_id, merge_id, pt_i, qm_i) if n_direct else None
        if not ints:
            res = (d0 if d0 is not None else 0.0, [])
            bundle_memo[key] = res
            return res
        nb = len(ints)
        # option tables, indexed by tail-scheme pti (inf = infeasible)
        C = np.full((nb, k), _INF)    # fork delivery + branch internal cost
        D = np.full((nb, k), _INF)    # merge delivery cost
        PH = np.full((nb, k), -1, np.int64)
        for bi, b in enumerate(ints):
            tail_id = branches[b].tail
            for pti in range(k):
                c, ph_i = ib_entry(b, pt_i, pti)
                if c == _INF:
                    continue
                C[bi, pti] = c
                D[bi, pti] = jscost(tail_id, merge_id, pti, qm_i)
                PH[bi, pti] = ph_i
            if not np.isfinite(C[bi]).any():
                bundle_memo[key] = (_INF, None)
                return (_INF, None)
        # candidates for "which delivery attains the merge max", in the
        # scalar scan order: the direct skip edge first, then options
        # branch-major / scheme-minor
        fbi, foi = np.nonzero(np.isfinite(C))
        m_vec = D[fbi, foi]
        fb = fbi
        fo = foi
        if d0 is not None:
            m_vec = np.concatenate(([d0], m_vec))
            fb = np.concatenate(([-1], fb))
            fo = np.concatenate(([-1], fo))
        feas = D[None, :, :] <= m_vec[:, None, None]
        cm = np.where(feas, C[None, :, :], _INF)
        best_oi = np.argmin(cm, axis=2)               # first min, pti order
        bc = np.take_along_axis(cm, best_oi[:, :, None], 2)[:, :, 0]
        bc_eff = bc.copy()
        rows = np.arange(len(m_vec))
        pin = fb >= 0
        bc_eff[rows[pin], fb[pin]] = C[fb[pin], fo[pin]]
        valid = np.isfinite(bc).all(axis=1)
        if d0 is not None:
            valid &= d0 <= m_vec
        totals = m_vec.copy()
        for bi in range(nb):          # branch order = scalar accumulation
            totals = totals + bc_eff[:, bi]
        totals = np.where(valid, totals, _INF)
        win = int(np.argmin(totals))
        best_total = float(totals[win])
        if best_total == _INF:
            bundle_memo[key] = (_INF, None)
            return (_INF, None)
        best_assign = []
        for bi in range(nb):
            pti = int(fo[win]) if bi == fb[win] else int(best_oi[win, bi])
            best_assign.append((ints[bi], int(PH[bi, pti]), pti))
        bundle_memo[key] = (best_total, best_assign)
        return best_total, best_assign

    # ---- spine DP (reverse) -----------------------------------------------
    # V[t][ph] = (cost from spine t's head onward, tail scheme, next head)
    V: List[Dict[int, Tuple[float, int, int]]] = [dict() for _ in range(K)]
    tail_id = branches[spine[-1]].tail
    for ph_i in range(k):
        best = (_INF, -1, -1)
        for pt_i in range(k):
            e = spine_tab[K - 1].get((ph_i, pt_i))
            if e is None:
                continue
            c = e[0] + jscost(tail_id, None, pt_i, None)
            if c < best[0]:
                best = (c, pt_i, -1)
        if best[0] < _INF:
            V[K - 1][ph_i] = best
    for t in range(K - 2, -1, -1):
        for ph_i in range(k):
            best = (_INF, -1, -1)
            for pt_i in range(k):
                e = spine_tab[t].get((ph_i, pt_i))
                if e is None:
                    continue
                for ph2, (suffix, _, _) in V[t + 1].items():
                    bc, _assign = bundle_solve(t, pt_i, ph2)
                    c = e[0] + bc + suffix
                    if c < best[0]:
                        best = (c, pt_i, ph2)
            if best[0] < _INF:
                V[t][ph_i] = best
    if not V[0]:
        raise RuntimeError(f"{graph.name}: no feasible plan found")
    ph = min(V[0], key=lambda p: V[0][p][0])
    total = V[0][ph][0]

    # ---- reconstruction ---------------------------------------------------
    steps: List[Optional[Tuple[Scheme, Mode]]] = [None] * len(layers)
    for t in range(K):
        _, pt_i, ph_next = V[t][ph]
        for idx, st in zip(branches[spine[t]].ids,
                           spine_tab[t][(ph, pt_i)][1]):
            steps[idx] = st
        if t < K - 1:
            _, assign = bundle_solve(t, pt_i, ph_next)
            for b, ph_b, pt_b in assign:
                for idx, st in zip(branches[b].ids,
                                   interior_tab[b][(ph_b, pt_b)][1]):
                    steps[idx] = st
            ph = ph_next
    return SearchResult(plan=Plan(tuple(steps)), cost=total, stats=stats)


def _dag_plan_search_batched(graph: ModelGraph, est: CostEstimator,
                             tb: Testbed, schemes: Tuple[Scheme, ...],
                             max_segment: int,
                             allow_fusion: bool) -> SearchResult:
    """Batched DAG search: register every branch segment/boundary and every
    junction delivery with one table registry, evaluate in a single pair of
    batched estimator calls, then run the ladder composition from the
    tables."""
    stats = SearchStats()
    layers = graph.layers
    branches = graph.linearize()

    registry = CostTableBuilder(est, tb)
    # geometrically identical branches (resnet101 repeats one bottleneck
    # body 23x) share one table registration and one pinned DP
    bkeys = [tuple(registry.layer_key(layers[i]) for i in br.ids)
             for br in branches]
    uniq: Dict[tuple, int] = {}
    finalizers = []
    for t, key in enumerate(bkeys):
        if key not in uniq:
            uniq[key] = len(finalizers)
            ls = [layers[i] for i in branches[t].ids]
            finalizers.append(plan_chain_tables(
                ls, registry, schemes, max_segment, allow_fusion, tb.nodes,
                with_final=False))

    # junction deliveries: every cross-branch (producer tail, consumer)
    # edge plus the final gather, all (src, dst) scheme pairs
    jidx: Dict[Tuple[int, Optional[int], int, Optional[int]], int] = {}
    for br in branches:
        tail = br.ids[-1]
        consumers = graph.consumer_ids[tail]
        if not consumers:
            for pi, p in enumerate(schemes):
                jidx[(tail, None, pi, None)] = registry.s_index(
                    layers[tail], None, p, None)
        for c in consumers:
            for pi, p in enumerate(schemes):
                for qi, q in enumerate(schemes):
                    jidx[(tail, c, pi, qi)] = registry.s_index(
                        layers[tail], layers[c], p, q)

    ivals, svals = registry.evaluate()
    utables = [fin(ivals, svals) for fin in finalizers]
    stats.i_calls = registry.i_entries
    stats.s_calls = registry.s_entries
    stats.pruned_halo = sum(utables[u].halo_cuts for u in uniq.values())

    dp_memo: Dict[Tuple[int, bool], Dict] = {}

    def btable(t: int, head_solo: bool):
        u = uniq[bkeys[t]]
        hit = dp_memo.get((u, head_solo))
        if hit is not None:
            return hit
        tbl = utables[u]

        def seg_costs(i: int, pi: int):
            return tbl.seg_options(i, pi, head_solo)

        out = _pinned_chain_dp(len(branches[t]), schemes, seg_costs,
                               tbl.bound, stats)
        dp_memo[(u, head_solo)] = out
        return out

    def jscost(prod: int, cons: Optional[int], pi: int,
               qi: Optional[int]) -> float:
        return float(svals[jidx[(prod, cons, pi, qi)]])

    return _dag_compose(graph, schemes, btable, jscost, stats)


# ---------------------------------------------------------------------------
# Reference (scalar-call) driver — kept as the parity/benchmark oracle.
# ---------------------------------------------------------------------------

def plan_search_reference(graph: ModelGraph, est: CostEstimator, tb: Testbed,
                          schemes: Sequence[Scheme] = ALL_SCHEMES,
                          max_segment: int = 32,
                          allow_fusion: bool = True) -> SearchResult:
    """Scalar-call DPP: one ``est.i_cost``/``est.s_cost`` invocation per
    sample.  Semantically identical to :func:`plan_search`; retained as the
    exactness oracle and the benchmark baseline."""
    if not graph.is_chain:
        return _dag_plan_search_reference(graph, est, tb, tuple(schemes),
                                          max_segment, allow_fusion)
    layers = graph.layers
    n = len(layers)
    k = len(schemes)
    stats = SearchStats()

    S: List[List[float]] = [[_INF] * k for _ in range(n + 1)]
    # choice[i][pi] = (segment_end_b, next_scheme_index or -1)
    choice: List[List[Tuple[int, int]]] = [[(-1, -1)] * k for _ in range(n + 1)]

    for i in range(n - 1, -1, -1):
        for pi, p in enumerate(schemes):
            best, best_choice = _INF, (-1, -1)
            stats.states += 1
            seg_hi = min(i + max_segment, n) if allow_fusion else i + 1
            for b in range(i, seg_hi):
                if b > i and not p.spatial:
                    break  # OutC cannot fuse (NT undefined)
                halos = halo_growth(layers[i:b + 1], b - i)
                if b > i and 2 * halos[0] >= min_shard_extent(
                        layers[i], p, tb.nodes):
                    stats.pruned_halo += 1
                    break  # halo degenerated into replication
                segcost = 0.0
                for off, m in enumerate(range(i, b + 1)):
                    segcost += est.i_cost(layers[m], p, tb,
                                          extra_halo=halos[off] if b > i else 0)
                    stats.i_calls += 1
                if segcost >= best:
                    stats.pruned_threshold += 1
                    break  # dynamic threshold: monotone in b
                if b == n - 1:
                    stats.s_calls += 1
                    c = segcost + est.s_cost(layers[b], None, p, None, tb)
                    if c < best:
                        best, best_choice = c, (b, -1)
                else:
                    for qi, q in enumerate(schemes):
                        if S[b + 1][qi] == _INF:
                            continue
                        stats.s_calls += 1
                        c = (segcost
                             + est.s_cost(layers[b], layers[b + 1], p, q, tb)
                             + S[b + 1][qi])
                        if c < best:
                            best, best_choice = c, (b, qi)
            S[i][pi] = best
            choice[i][pi] = best_choice

    pi = min(range(k), key=lambda j: S[0][j])
    total = S[0][pi]
    steps: List[Tuple[Scheme, Mode]] = []
    i = 0
    while i < n:
        b, qi = choice[i][pi]
        p = schemes[pi]
        for m in range(i, b + 1):
            steps.append((p, Mode.NT if m < b else Mode.T))
        i = b + 1
        if qi >= 0:
            pi = qi
    return SearchResult(plan=Plan(tuple(steps)), cost=total, stats=stats)


def _dag_plan_search_reference(graph: ModelGraph, est: CostEstimator,
                               tb: Testbed, schemes: Tuple[Scheme, ...],
                               max_segment: int,
                               allow_fusion: bool) -> SearchResult:
    stats = SearchStats()
    layers = graph.layers

    def icost(l, p, halo=0):
        stats.i_calls += 1
        return est.i_cost(l, p, tb, extra_halo=halo)

    def scost(l, nxt, s, d):
        stats.s_calls += 1
        return est.s_cost(l, nxt, s, d, tb)

    branches = graph.linearize()

    def btable(t: int, head_solo: bool):
        ls = [layers[i] for i in branches[t].ids]
        return _scalar_chain_tables(ls, icost, scost, schemes, max_segment,
                                    allow_fusion, head_solo, tb.nodes, stats)

    def jscost(prod: int, cons: Optional[int], pi: int,
               qi: Optional[int]) -> float:
        return scost(layers[prod], None if cons is None else layers[cons],
                     schemes[pi], None if qi is None else schemes[qi])

    return _dag_compose(graph, schemes, btable, jscost, stats)


# ---------------------------------------------------------------------------
# Pipelined-cost objectives: exact Pareto-frontier DP over (compute, sync)
# occupancy pairs.
#
# Under pipelined serving the two resource classes overlap across requests,
# so a plan's steady-state period is max(sum of segment i-costs, sum of
# sync s-costs) — see ``plan.PipelineCost``.  Both that bottleneck and the
# single-request latency (the sum) are monotone in the pair, and every DP
# composition step (segment extension, boundary crossing, fork delivery,
# merge max, bundle/spine concatenation) is monotone too, so propagating
# nondominated (compute, sync) suffix sets is exact for *any* monotone
# objective of the pair.  One frontier therefore serves THROUGHPUT,
# P99_BOUNDED and latency selection — and the simulator-in-the-loop
# refinement, which only rescales the two axes (``cluster.refine``).
#
# The frontier runs from the same batched cost tables as the latency DP
# (one i_cost_batch + one s_cost_batch call; the per-state merges are
# numpy lexsort/cummin reductions — no scalar estimator fallback).  A
# latency-optimal search seeds the upper bound: any partial pair with a
# coordinate beyond the latency optimum can never win (completions only
# add), which keeps suffix frontiers small.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _FSet:
    """One state's nondominated suffix set: parallel point arrays."""

    a: np.ndarray                  # compute occupancy (sum of i-costs)
    b: np.ndarray                  # sync occupancy (sum of s-costs)
    back: tuple                    # per-point reconstruction payload


def _chain_frontier(n: int, k: int, seg_options, bound, final,
                    ub: float, stats: SearchStats,
                    warm: Optional[Tuple[int, list]] = None):
    """Reverse Pareto DP over one full chain (final gather included).

    ``F[i][pi]`` holds the nondominated (compute, sync) suffix pairs from
    layer ``i`` given segment scheme ``schemes[pi]``; back-pointers are
    ``(segment_end, next_scheme_or_-1, next_point)``.

    ``warm=(start, F_prev)`` warm-starts from surviving suffix frontiers:
    the caller has verified that every table row reachable from layers
    ``>= start`` is unchanged since ``F_prev`` was computed (segment costs,
    boundary syncs and the final gather), so those suffix sets are reused
    verbatim and the reverse DP only recomputes layers ``< start``.
    ``stats.states`` counts recomputed states only.
    """
    start = n if warm is None else warm[0]
    F: List[List[Optional[_FSet]]] = [[None] * k for _ in range(n)]
    if warm is not None:
        for i in range(start, n):
            F[i] = list(warm[1][i])
    for i in range(min(start, n) - 1, -1, -1):
        for pi in range(k):
            As: List[np.ndarray] = []
            Bs: List[np.ndarray] = []
            Eb: List[np.ndarray] = []
            Qs: List[np.ndarray] = []
            Nx: List[np.ndarray] = []
            for bnd, segcost in seg_options(i, pi):
                if bnd == n - 1:
                    As.append(np.asarray([segcost]))
                    Bs.append(np.asarray([final(pi)]))
                    Eb.append(np.asarray([bnd]))
                    Qs.append(np.asarray([-1]))
                    Nx.append(np.asarray([-1]))
                    continue
                for qi in range(k):
                    Fn = F[bnd + 1][qi]
                    if Fn is None:
                        continue
                    m = len(Fn.a)
                    As.append(segcost + Fn.a)
                    Bs.append(bound(bnd, pi, qi) + Fn.b)
                    Eb.append(np.full(m, bnd))
                    Qs.append(np.full(m, qi))
                    Nx.append(np.arange(m))
            if not As:
                continue
            a = np.concatenate(As)
            b = np.concatenate(Bs)
            keep = pareto_front_2d(a, b, ub)
            if not len(keep):
                continue
            stats.states += len(keep)
            F[i][pi] = _FSet(a[keep], b[keep],
                             (np.concatenate(Eb)[keep],
                              np.concatenate(Qs)[keep],
                              np.concatenate(Nx)[keep]))
    return F


def _chain_plan_from(F, schemes: Tuple[Scheme, ...], pi: int,
                     idx: int) -> Plan:
    steps: List[Tuple[Scheme, Mode]] = []
    i = 0
    while True:
        fs = F[i][pi]
        bnd = int(fs.back[0][idx])
        qi = int(fs.back[1][idx])
        nxt = int(fs.back[2][idx])
        p = schemes[pi]
        for m in range(i, bnd + 1):
            steps.append((p, Mode.NT if m < bnd else Mode.T))
        if qi < 0:
            return Plan(tuple(steps))
        i, pi, idx = bnd + 1, qi, nxt


def _pinned_pareto_tables(n: int, schemes: Tuple[Scheme, ...], seg_costs,
                          bound_cost, ub: float, stats: SearchStats) -> Dict:
    """Per-branch Pareto counterpart of :func:`_pinned_chain_dp`.

    Returns ``{(head_idx, tail_idx): (a, b, steps)}`` — the nondominated
    *internal* (compute, sync) pairs of the branch with pinned head/tail
    schemes, with the realizing step tuples materialised per point
    (branches are short, so eager reconstruction is cheap).
    """
    k = len(schemes)
    out: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray, list]] = {}
    for ti in range(k):
        F: List[List[Optional[_FSet]]] = [[None] * k for _ in range(n)]
        for i in range(n - 1, -1, -1):
            for pi in range(k):
                As, Bs, Eb, Qs, Nx = [], [], [], [], []
                for bnd, segcost in seg_costs(i, pi):
                    if bnd == n - 1:
                        if pi != ti:
                            continue
                        As.append(np.asarray([segcost]))
                        Bs.append(np.asarray([0.0]))
                        Eb.append(np.asarray([bnd]))
                        Qs.append(np.asarray([-1]))
                        Nx.append(np.asarray([-1]))
                        continue
                    for qi in range(k):
                        Fn = F[bnd + 1][qi]
                        if Fn is None:
                            continue
                        m = len(Fn.a)
                        As.append(segcost + Fn.a)
                        Bs.append(bound_cost(bnd, pi, qi) + Fn.b)
                        Eb.append(np.full(m, bnd))
                        Qs.append(np.full(m, qi))
                        Nx.append(np.arange(m))
                if not As:
                    continue
                a = np.concatenate(As)
                b = np.concatenate(Bs)
                keep = pareto_front_2d(a, b, ub)
                if not len(keep):
                    continue
                stats.states += len(keep)
                F[i][pi] = _FSet(a[keep], b[keep],
                                 (np.concatenate(Eb)[keep],
                                  np.concatenate(Qs)[keep],
                                  np.concatenate(Nx)[keep]))
        for pi in range(k):
            if F[0][pi] is None:
                continue
            fs = F[0][pi]
            steps = [tuple(_chain_plan_from(F, schemes, pi, j).steps)
                     for j in range(len(fs.a))]
            out[(pi, ti)] = (fs.a, fs.b, steps)
    return out


def _dag_pipeline_frontier(graph: ModelGraph, schemes: Tuple[Scheme, ...],
                           ptable, jscost, ub: float, stats: SearchStats):
    """Ladder composition of per-branch Pareto tables.

    Returns ``(points, build_plan)``: the root nondominated set over the
    whole DAG plus a reconstruction callable.  Mirrors ``_dag_compose``
    stage semantics — fork deliveries add to the sync axis, each merge
    contributes the max over its incoming deliveries (one merge stage),
    the spine tail pays the final gather.
    """
    branches, spine, bundles = _ladder(graph)
    k = len(schemes)
    K = len(spine)

    spine_tab = [ptable(s, idx > 0) for idx, s in enumerate(spine)]
    interior_tab = {b: ptable(b, False)
                    for ints, _ in bundles for b in ints}

    bundle_memo: Dict[Tuple[int, int, int], Optional[tuple]] = {}

    def bundle_frontier(t: int, pt_i: int, qm_i: int) -> Optional[tuple]:
        """Nondominated (compute, sync) contributions of bundle ``t`` given
        fork tail / merge head schemes; back payload = per-interior-branch
        ``(branch_id, steps)`` assignments."""
        key = (t, pt_i, qm_i)
        if key in bundle_memo:
            return bundle_memo[key]
        ints, n_direct = bundles[t]
        fork_id = branches[spine[t]].tail
        merge_id = branches[spine[t + 1]].head
        d0 = jscost(fork_id, merge_id, pt_i, qm_i) if n_direct else None
        if not ints:
            res = (np.zeros(1), np.asarray([d0 if d0 is not None else 0.0]),
                   [()])
            bundle_memo[key] = res
            return res
        opts = []
        for b in ints:
            head_id = branches[b].head
            tail_id = branches[b].tail
            fid = graph.producer_ids[head_id][0]
            A, B, D, back = [], [], [], []
            for (ph_i, pti), (aa, bb, steps) in interior_tab[b].items():
                fork = jscost(fid, head_id, pt_i, ph_i)
                d = jscost(tail_id, merge_id, pti, qm_i)
                for j in range(len(aa)):
                    A.append(float(aa[j]))
                    B.append(fork + float(bb[j]))
                    D.append(d)
                    back.append((b, steps[j]))
            if not A:
                bundle_memo[key] = None
                return None
            keep = pareto_front_nd([np.asarray(A), np.asarray(B),
                                    np.asarray(D)])
            opts.append((np.asarray(A)[keep], np.asarray(B)[keep],
                         np.asarray(D)[keep], [back[j] for j in keep]))
        shapes = [len(o[0]) for o in opts]
        grid = np.indices(shapes).reshape(len(opts), -1)
        A = np.zeros(grid.shape[1])
        B = np.zeros(grid.shape[1])
        Ds = []
        for o, g in zip(opts, grid):
            A = A + o[0][g]
            B = B + o[1][g]
            Ds.append(o[2][g])
        D = np.maximum.reduce(Ds)
        if d0 is not None:
            D = np.maximum(D, d0)
        b_tot = B + D
        keep = pareto_front_2d(A, b_tot, ub)
        if not len(keep):
            bundle_memo[key] = None
            return None
        back_out = [tuple(opts[bi][3][int(grid[bi, j])]
                          for bi in range(len(opts))) for j in keep]
        res = (A[keep], b_tot[keep], back_out)
        bundle_memo[key] = res
        return res

    # ---- spine DP (reverse): V[t][ph] = suffix frontier -------------------
    # back payload: (pt, branch_point, bundle_assign, next_head, next_point)
    V: List[Dict[int, tuple]] = [dict() for _ in range(K)]
    tail_id = branches[spine[-1]].tail
    for ph_i in range(k):
        As, Bs, back = [], [], []
        for pt_i in range(k):
            e = spine_tab[K - 1].get((ph_i, pt_i))
            if e is None:
                continue
            gather = jscost(tail_id, None, pt_i, None)
            aa, bb, _steps = e
            for j in range(len(aa)):
                As.append(float(aa[j]))
                Bs.append(float(bb[j]) + gather)
                back.append((pt_i, j, (), -1, -1))
        if not As:
            continue
        a = np.asarray(As)
        b = np.asarray(Bs)
        keep = pareto_front_2d(a, b, ub)
        if len(keep):
            stats.states += len(keep)
            V[K - 1][ph_i] = (a[keep], b[keep], [back[j] for j in keep])
    for t in range(K - 2, -1, -1):
        for ph_i in range(k):
            As, Bs = [], []
            chunks = []           # (offset, pt, ph2, shape, bundle_back)
            total = 0
            for pt_i in range(k):
                e = spine_tab[t].get((ph_i, pt_i))
                if e is None:
                    continue
                ea, eb, _steps = e
                for ph2, (sa, sb, _sback) in V[t + 1].items():
                    bf = bundle_frontier(t, pt_i, ph2)
                    if bf is None:
                        continue
                    ba, bb2, bback = bf
                    A3 = ea[:, None, None] + ba[None, :, None] \
                        + sa[None, None, :]
                    B3 = eb[:, None, None] + bb2[None, :, None] \
                        + sb[None, None, :]
                    As.append(A3.ravel())
                    Bs.append(B3.ravel())
                    chunks.append((total, pt_i, ph2, A3.shape, bback))
                    total += A3.size
            if not As:
                continue
            a = np.concatenate(As)
            b = np.concatenate(Bs)
            keep = pareto_front_2d(a, b, ub)
            if not len(keep):
                continue
            stats.states += len(keep)
            offs = [c[0] for c in chunks]
            back = []
            for j in keep:
                ci = bisect.bisect_right(offs, int(j)) - 1
                off, pt_i, ph2, (m1, m2, m3), bback = chunks[ci]
                e1, rem = divmod(int(j) - off, m2 * m3)
                e2, e3 = divmod(rem, m3)
                back.append((pt_i, e1, bback[e2], ph2, e3))
            V[t][ph_i] = (a[keep], b[keep], back)

    if not V[0]:
        raise RuntimeError(f"{graph.name}: no feasible plan found")

    roots = []                    # (ph, point_idx) per root frontier point
    As, Bs = [], []
    for ph_i, (a, b, _back) in V[0].items():
        for j in range(len(a)):
            As.append(float(a[j]))
            Bs.append(float(b[j]))
            roots.append((ph_i, j))
    a = np.asarray(As)
    b = np.asarray(Bs)
    keep = pareto_front_2d(a, b, ub)
    points = np.stack([a[keep], b[keep]], axis=1)
    kept_roots = [roots[int(j)] for j in keep]

    def build_plan(idx: int) -> Plan:
        ph_i, j = kept_roots[idx]
        steps: List[Optional[Tuple[Scheme, Mode]]] = [None] * len(graph)
        t = 0
        while True:
            _a, _b, back = V[t][ph_i]
            pt_i, e_idx, assign, ph2, nxt = back[j]
            for lid, st in zip(branches[spine[t]].ids,
                               spine_tab[t][(ph_i, pt_i)][2][e_idx]):
                steps[lid] = st
            if ph2 < 0:
                return Plan(tuple(steps))
            for bid, bsteps in assign:
                for lid, st in zip(branches[bid].ids, bsteps):
                    steps[lid] = st
            ph_i, j = ph2, nxt
            t += 1

    return points, build_plan


@dataclasses.dataclass
class PlanFrontier:
    """Latency/throughput Pareto frontier of one planning problem.

    ``points[i] = (compute_s, sync_s)`` — nondominated per-resource-class
    occupancy pairs over valid plans, compute ascending.  Every monotone
    objective of the pair has its optimum on this set, so selection (and
    the simulator-in-the-loop re-weighting, which only scales the axes)
    never rebuilds the tables.

    Built with ``prune_ub=True`` (the ``plan_search`` default) the set is
    additionally trimmed to points whose coordinates stay within the
    latency optimum — exact for the *unscaled* objectives (a coordinate
    beyond the latency optimum can never win ``max(a, b)`` or the bounded
    variants) but potentially missing extreme points that only win under
    strong axis re-weighting; build with ``prune_ub=False`` (what
    ``cluster.refine`` does) when scaled re-selection must be exact over
    the complete set.
    """

    schemes: Tuple[Scheme, ...]
    points: np.ndarray
    stats: SearchStats
    _build: Callable[[int], Plan]

    def __len__(self) -> int:
        return len(self.points)

    def plan(self, idx: int) -> Plan:
        """Materialise the plan realizing ``points[idx]``."""
        return self._build(int(idx))

    def select(self, objective: Objective = Objective.THROUGHPUT,
               latency_bound_s: Optional[float] = None,
               compute_scale: float = 1.0,
               sync_scale: float = 1.0) -> int:
        """Index of the objective-optimal point.  ``compute_scale`` /
        ``sync_scale`` re-weight the two resource classes (the refinement
        loop sets them from simulator occupancy measurements)."""
        best = None
        best_key = None
        for i in range(len(self.points)):
            key = pipeline_objective_key(
                float(self.points[i, 0]) * compute_scale,
                float(self.points[i, 1]) * sync_scale,
                objective, latency_bound_s)
            if best_key is None or key < best_key:
                best, best_key = i, key
        if best is None:
            raise RuntimeError("empty frontier")
        return best

    def search_result(self, objective: Objective,
                      latency_bound_s: Optional[float] = None
                      ) -> SearchResult:
        i = self.select(objective, latency_bound_s)
        a, b = float(self.points[i, 0]), float(self.points[i, 1])
        return SearchResult(plan=self.plan(i), cost=max(a, b),
                            stats=self.stats, objective=objective,
                            pipeline=PipelineCost(a, b))


@dataclasses.dataclass
class FrontierTables:
    """Reusable registration artifacts of one ``pipeline_frontier`` problem.

    Splits the batched frontier build into its three phases so incremental
    replanning (``cluster.elastic``) can redo only what a cluster event
    invalidated:

    1. **register** — enumerate/dedup every admissible segment, boundary
       and junction query (the Python-heavy phase).  Depends only on graph
       geometry and the testbed projection, so any capability change that
       leaves ``cluster.compat_testbed()`` intact reuses it wholesale.
    2. **evaluate** — resolve the registered rows in one
       ``i_cost_batch``/``s_cost_batch`` pair.  ``est`` swaps the
       estimator (same rows, new capabilities); ``ivals``/``svals`` reuse
       a cached side verbatim (a derate dirties only i-rows, a link change
       only s-rows).
    3. **frontier** — assemble tables and run the Pareto DP.  Consecutive
       calls on one instance warm-start from the previous build: chain
       suffix frontiers whose reachable table rows are value-identical are
       reused (``_chain_frontier(warm=...)``); on DAGs, per-unique-branch
       pinned Pareto tables are reused when that branch's seg/bound rows
       are unchanged.  ``last_reuse`` reports what fired.

    ``pipeline_frontier`` routes every batched build through a fresh
    instance, so the one-shot path and the incremental path are the same
    code — a warm rebuild is bit-identical to a scratch build by
    construction (the reused suffix sets are recomputed-value-equal).
    """

    graph: ModelGraph
    tb: Testbed
    schemes: Tuple[Scheme, ...]
    max_segment: int
    allow_fusion: bool
    builder: CostTableBuilder
    _chain_fin: Optional[Callable] = None
    _branches: Optional[list] = None
    _bkeys: Optional[list] = None
    _uniq: Optional[Dict] = None
    _finalizers: Optional[list] = None
    _jidx: Optional[Dict] = None
    #: what the most recent :meth:`frontier` call reused from the previous
    #: build on this instance (empty before the first build)
    last_reuse: Dict = dataclasses.field(default_factory=dict)
    _last: Optional[Dict] = dataclasses.field(default=None, repr=False)

    @classmethod
    def register(cls, graph: ModelGraph, est: CostEstimator, tb: Testbed,
                 schemes: Sequence[Scheme] = ALL_SCHEMES,
                 max_segment: int = 32,
                 allow_fusion: bool = True) -> "FrontierTables":
        """Phase 1: build the query registration for ``graph`` on ``tb``.
        ``est`` must implement the batched protocol; it is only stored as
        the default evaluator (registration never calls it)."""
        with _obs_trace.span(_obs_trace.PLANNER_TRACK,
                             "frontier.register", cat="planner",
                             graph=graph.name):
            return cls._register(graph, est, tb, schemes, max_segment,
                                 allow_fusion)

    @classmethod
    def _register(cls, graph: ModelGraph, est: CostEstimator, tb: Testbed,
                  schemes: Sequence[Scheme] = ALL_SCHEMES,
                  max_segment: int = 32,
                  allow_fusion: bool = True) -> "FrontierTables":
        if not hasattr(est, "i_cost_batch"):
            raise TypeError("FrontierTables requires the batched estimator "
                            "protocol (est.i_cost_batch)")
        schemes_t = tuple(schemes)
        builder = CostTableBuilder(est, tb)
        if graph.is_chain:
            fin = plan_chain_tables(graph.layers, builder, schemes_t,
                                    max_segment, allow_fusion, tb.nodes,
                                    with_final=True)
            return cls(graph, tb, schemes_t, max_segment, allow_fusion,
                       builder, _chain_fin=fin)
        layers = graph.layers
        branches = graph.linearize()
        bkeys = [tuple(builder.layer_key(layers[i]) for i in br.ids)
                 for br in branches]
        uniq: Dict[tuple, int] = {}
        finalizers: List[Callable] = []
        for t, bkey in enumerate(bkeys):
            if bkey not in uniq:
                uniq[bkey] = len(finalizers)
                ls = [layers[i] for i in branches[t].ids]
                finalizers.append(plan_chain_tables(
                    ls, builder, schemes_t, max_segment, allow_fusion,
                    tb.nodes, with_final=False))
        jidx: Dict[Tuple[int, Optional[int], int, Optional[int]], int] = {}
        for br in branches:
            tail = br.ids[-1]
            consumers = graph.consumer_ids[tail]
            if not consumers:
                for pi, p in enumerate(schemes_t):
                    jidx[(tail, None, pi, None)] = builder.s_index(
                        layers[tail], None, p, None)
            for c in consumers:
                for pi, p in enumerate(schemes_t):
                    for qi, q in enumerate(schemes_t):
                        jidx[(tail, c, pi, qi)] = builder.s_index(
                            layers[tail], layers[c], p, q)
        return cls(graph, tb, schemes_t, max_segment, allow_fusion, builder,
                   _branches=branches, _bkeys=bkeys, _uniq=uniq,
                   _finalizers=finalizers, _jidx=jidx)

    def evaluate(self, est: Optional[CostEstimator] = None,
                 ivals: Optional[np.ndarray] = None,
                 svals: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Phase 2: resolve the registered rows (see
        :meth:`CostTableBuilder.evaluate` for the reuse semantics)."""
        with _obs_trace.span(_obs_trace.PLANNER_TRACK,
                             "frontier.evaluate", cat="planner",
                             graph=self.graph.name,
                             reuse_ivals=ivals is not None,
                             reuse_svals=svals is not None):
            return self.builder.evaluate(est=est, ivals=ivals,
                                         svals=svals)

    # -- phase 3 ------------------------------------------------------------

    def _chain_suffix_start(self, tbl) -> int:
        """Deepest ``i0`` with every table row reachable from layers
        ``>= i0`` unchanged vs. the previous build (suffix frontiers above
        it survive verbatim); ``tbl.n`` when nothing survives."""
        old = self._last["tbl"]
        n = tbl.n
        if not np.array_equal(tbl.s_final, old.s_final, equal_nan=True):
            return n
        i0 = n
        while i0 > 0:
            i = i0 - 1
            if not np.array_equal(tbl.seg[i], old.seg[i]):
                break
            if i < n - 1 and not np.array_equal(tbl.sbound[i],
                                                old.sbound[i]):
                break
            i0 = i
        return i0

    def frontier(self, ivals: np.ndarray, svals: np.ndarray,
                 ub: float = _INF, warm: bool = True) -> PlanFrontier:
        """Phase 3: assemble tables from the evaluated rows and run the
        Pareto DP, warm-starting from the previous build on this instance
        when ``warm`` (value-equal suffixes/branches only, so the result
        is always bit-identical to a scratch build)."""
        stats = SearchStats(i_calls=self.builder.i_entries,
                            s_calls=self.builder.s_entries)
        with _obs_trace.span(_obs_trace.PLANNER_TRACK, "frontier.dp",
                             cat="planner", graph=self.graph.name,
                             warm=warm) as sp:
            if self._chain_fin is not None:
                fr = self._frontier_chain(ivals, svals, ub, warm, stats)
            else:
                fr = self._frontier_dag(ivals, svals, ub, warm, stats)
            sp.set(points=len(fr.points), **self.last_reuse)
            return fr

    def _frontier_chain(self, ivals, svals, ub, warm, stats):
        schemes_t = self.schemes
        n = len(self.graph)
        k = len(schemes_t)
        tbl = self._chain_fin(ivals, svals)
        stats.pruned_halo = tbl.halo_cuts
        warm_arg = None
        reused = 0
        if warm and self._last is not None and self._last["ub"] == ub:
            i0 = self._chain_suffix_start(tbl)
            if i0 < n:
                warm_arg = (i0, self._last["F"])
                reused = n - i0
        F = _chain_frontier(n, k, tbl.seg_options, tbl.bound, tbl.final,
                            ub, stats, warm=warm_arg)
        self._last = {"tbl": tbl, "F": F, "ub": ub}
        self.last_reuse = {"mode": "chain", "layers": n,
                           "suffix_reused_layers": reused}
        roots = []
        As: List[float] = []
        Bs: List[float] = []
        for pi in range(k):
            if F[0][pi] is None:
                continue
            fs = F[0][pi]
            for j in range(len(fs.a)):
                As.append(float(fs.a[j]))
                Bs.append(float(fs.b[j]))
                roots.append((pi, j))
        if not roots:
            raise RuntimeError(f"{self.graph.name}: no feasible plan found")
        a = np.asarray(As)
        b = np.asarray(Bs)
        keep = pareto_front_2d(a, b, ub)
        points = np.stack([a[keep], b[keep]], axis=1)
        kept = [roots[int(j)] for j in keep]

        def build(idx: int) -> Plan:
            pi, j = kept[idx]
            return _chain_plan_from(F, schemes_t, pi, j)

        return PlanFrontier(schemes_t, points, stats, build)

    def _frontier_dag(self, ivals, svals, ub, warm, stats):
        graph = self.graph
        schemes_t = self.schemes
        branches = self._branches
        bkeys, uniq, jidx = self._bkeys, self._uniq, self._jidx
        utables = [fin(ivals, svals) for fin in self._finalizers]
        stats.pruned_halo = sum(utables[u].halo_cuts for u in uniq.values())
        ptab_memo: Dict[Tuple[int, bool], Dict] = {}
        reused_branches = 0
        if warm and self._last is not None and self._last["ub"] == ub:
            prev_ut = self._last["utables"]
            for u, tblu in enumerate(utables):
                old = prev_ut[u]
                # pinned per-branch tables read seg + internal bounds only
                if np.array_equal(tblu.seg, old.seg) \
                        and np.array_equal(tblu.sbound, old.sbound):
                    for (uu, hs), v in self._last["ptab"].items():
                        if uu == u:
                            ptab_memo[(u, hs)] = v
                    reused_branches += 1

        def ptable(t: int, head_solo: bool):
            u = uniq[bkeys[t]]
            hit = ptab_memo.get((u, head_solo))
            if hit is not None:
                return hit
            tblu = utables[u]

            def seg_costs(i: int, pi: int):
                return tblu.seg_options(i, pi, head_solo)

            out = _pinned_pareto_tables(len(branches[t]), schemes_t,
                                        seg_costs, tblu.bound, ub, stats)
            ptab_memo[(u, head_solo)] = out
            return out

        def jscost(prod: int, cons: Optional[int], pi: int,
                   qi: Optional[int]) -> float:
            return float(svals[jidx[(prod, cons, pi, qi)]])

        points, build = _dag_pipeline_frontier(graph, schemes_t, ptable,
                                               jscost, ub, stats)
        self._last = {"utables": utables, "ptab": ptab_memo, "ub": ub}
        self.last_reuse = {"mode": "dag", "unique_branches": len(utables),
                           "branch_tables_reused": reused_branches}
        return PlanFrontier(schemes_t, points, stats, build)


def pipeline_frontier(graph: ModelGraph, est: CostEstimator, tb: Testbed,
                      schemes: Sequence[Scheme] = ALL_SCHEMES,
                      max_segment: int = 32,
                      allow_fusion: bool = True,
                      ub_cost: Optional[float] = None,
                      prune_ub: bool = True) -> PlanFrontier:
    """Exact (compute, sync) Pareto frontier of all valid plans.

    Batched estimators evaluate through one ``i_cost_batch`` +
    ``s_cost_batch`` table build (the latency DP's tables, reused);
    scalar-only estimators run the same search from per-query providers.

    ``prune_ub=True`` trims partial pairs against the latency optimum —
    exact for the unscaled objectives and what ``plan_search`` uses; pass
    ``ub_cost`` (the latency of any feasible plan under the *same*
    schemes/fusion settings, e.g. a latency ``plan_search`` the caller
    already ran) to skip the internal pre-search.  ``prune_ub=False``
    keeps the complete nondominated set (no pre-search at all) — needed
    when ``select`` will re-weight the axes (see ``cluster.refine``).
    """
    schemes_t = tuple(schemes)
    k = len(schemes_t)
    stats = SearchStats()
    if not prune_ub:
        ub = _INF
    else:
        # Latency optimum: every frontier coordinate is bounded by it
        # (both axes sum to the latency), so it is a valid cutoff.
        if ub_cost is None:
            ub_cost = plan_search(graph, est, tb, schemes_t, max_segment,
                                  allow_fusion).cost
        ub = ub_cost * (1.0 + 1e-12)
    if hasattr(est, "i_cost_batch"):
        # batched estimators route through the registration/evaluation/DP
        # split (one fresh instance here; cluster.elastic holds onto one
        # across cluster events for incremental rebuilds)
        ft = FrontierTables.register(graph, est, tb, schemes_t, max_segment,
                                     allow_fusion)
        return ft.frontier(*ft.evaluate(), ub=ub)

    if graph.is_chain:
        n = len(graph)
        ls = list(graph.layers)

        def icost(l, p, halo=0):
            stats.i_calls += 1
            return est.i_cost(l, p, tb, extra_halo=halo)

        def scost(l, nxt, s, d):
            stats.s_calls += 1
            return est.s_cost(l, nxt, s, d, tb)

        seg_options, bound = _scalar_chain_providers(
            ls, icost, scost, schemes_t, max_segment, allow_fusion,
            False, tb.nodes, stats)
        fin_cache: Dict[int, float] = {}

        def final(pi: int) -> float:
            hit = fin_cache.get(pi)
            if hit is None:
                hit = scost(ls[-1], None, schemes_t[pi], None)
                fin_cache[pi] = hit
            return hit

        F = _chain_frontier(n, k, seg_options, bound, final, ub, stats)
        roots = []
        As, Bs = [], []
        for pi in range(k):
            if F[0][pi] is None:
                continue
            fs = F[0][pi]
            for j in range(len(fs.a)):
                As.append(float(fs.a[j]))
                Bs.append(float(fs.b[j]))
                roots.append((pi, j))
        if not roots:
            raise RuntimeError(f"{graph.name}: no feasible plan found")
        a = np.asarray(As)
        b = np.asarray(Bs)
        keep = pareto_front_2d(a, b, ub)
        points = np.stack([a[keep], b[keep]], axis=1)
        kept = [roots[int(j)] for j in keep]

        def build(idx: int) -> Plan:
            pi, j = kept[idx]
            return _chain_plan_from(F, schemes_t, pi, j)

        return PlanFrontier(schemes_t, points, stats, build)

    # ---- DAG (scalar-only estimators) -------------------------------------
    layers = graph.layers
    branches = graph.linearize()

    def icost(l, p, halo=0):
        stats.i_calls += 1
        return est.i_cost(l, p, tb, extra_halo=halo)

    def scost(l, nxt, s, d):
        stats.s_calls += 1
        return est.s_cost(l, nxt, s, d, tb)

    ptab_memo2: Dict[Tuple[int, bool], Dict] = {}

    def ptable(t: int, head_solo: bool):
        hit = ptab_memo2.get((t, head_solo))
        if hit is not None:
            return hit
        ls = [layers[i] for i in branches[t].ids]
        seg_costs, bound_cost = _scalar_chain_providers(
            ls, icost, scost, schemes_t, max_segment, allow_fusion,
            head_solo, tb.nodes, stats)
        out = _pinned_pareto_tables(len(ls), schemes_t, seg_costs,
                                    bound_cost, ub, stats)
        ptab_memo2[(t, head_solo)] = out
        return out

    def jscost(prod: int, cons: Optional[int], pi: int,
               qi: Optional[int]) -> float:
        return scost(layers[prod],
                     None if cons is None else layers[cons],
                     schemes_t[pi],
                     None if qi is None else schemes_t[qi])

    points, build = _dag_pipeline_frontier(graph, schemes_t, ptable, jscost,
                                           ub, stats)
    return PlanFrontier(schemes_t, points, stats, build)
