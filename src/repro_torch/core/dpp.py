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

Every i-/s-cost the DP can touch is precomputed through ``core.cost_tables``
in one batched ``i_cost_batch`` + one ``s_cost_batch`` estimator call, and
the chain DP runs as numpy reductions over the scheme axis.  The batched DP
replicates the scalar tie-breaking (first minimum wins in ``b`` then ``q``
order), so it returns the JAX package's plans and costs bit for bit.

A trimmed copy of the JAX package's ``core/dpp.py``: the latency objective
only.  The throughput/P99 frontier DP, the scalar reference search and the
tracing spans are left out.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .cost import Testbed
from .cost_tables import CostTableBuilder, plan_chain_tables
from .estimator import CostEstimator
from .graph import ModelGraph
from .partition import ALL_SCHEMES, Mode, Scheme
from .plan import Plan

_INF = float("inf")


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


def plan_search(graph: ModelGraph, est: CostEstimator, tb: Testbed,
                schemes: Sequence[Scheme] = ALL_SCHEMES,
                max_segment: int = 32,
                allow_fusion: bool = True) -> SearchResult:
    """Run DPP from precomputed batched cost tables.  ``allow_fusion=False``
    restricts to all-T plans (the layerwise baseline); ``schemes``
    restricted to one scheme with fusion on gives the fused-layer baseline.
    Dispatches to the per-branch DAG composition when the graph is not a
    chain.

    The estimator must implement the batched protocol
    (``BatchedCostEstimator``); the tables assume its costs are determined
    by the feature expression."""
    if not hasattr(est, "i_cost_batch"):
        raise TypeError(
            f"{type(est).__name__} lacks i_cost_batch/s_cost_batch; the "
            f"port's planner runs only batched estimators")
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
    fin = plan_chain_tables(layers, registry, schemes, max_segment,
                            allow_fusion, tb.nodes, with_final=True)
    tbl = fin(*registry.evaluate())
    seg = tbl.seg                        # (n, k, cap), +inf = inadmissible
    cap = seg.shape[2]

    S = np.full((n + 1, k), _INF)
    choice_b = np.full((n, k), -1, np.int64)
    choice_q = np.full((n, k), -1, np.int64)
    ks = np.arange(k)
    for i in range(n - 1, -1, -1):
        m = min(cap, n - i)
        # cand[p, L, q] = (seg + boundary s-cost) + suffix — the same
        # float association as the scalar reference, so costs stay
        # bit-identical
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
# Per-branch chain DP with pinned boundary layouts (the DAG search's unit).
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
