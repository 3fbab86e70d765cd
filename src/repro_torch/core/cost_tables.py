"""Batched cost tables — the planner's scalar-call hot path, precomputed.

Every (layer, scheme, halo) compute query and every (boundary, src-scheme,
dst-scheme) sync query a search could touch is enumerated up front,
deduplicated, evaluated in **one** ``i_cost_batch`` / ``s_cost_batch`` call
each, and served back as numpy tables.  The tables hold exactly the values
the scalar protocol would have returned (the estimator guarantees bit-parity
between its scalar and batched paths), so any search driven from them
reproduces the scalar reference bit for bit.

Two consumers: ``repro_torch.core.dpp`` (the chain DP over the ``seg``
tensor, per-branch tables for DAG composition, the frontier DP) and
:class:`PrefetchedEstimator`, a ``CostEstimator`` view for code that walks
plans scalar-wise (the exhaustive oracle, the fixed-plan baselines).

A copy of the JAX package's ``core/cost_tables.py``: the dedup counters of
:class:`CostTableBuilder` and the prefetch counters are pushed to the
installed ``repro_torch.obs`` metrics registry (a no-op without one).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import metrics as _obs_metrics

from .cost import Testbed
from .estimator import CostEstimator, i_features, s_features
from .graph import LayerSpec, ModelGraph, halo_growth
from .partition import ALL_SCHEMES, Scheme, min_shard_extent

_INF = float("inf")


def _i_key(layer: LayerSpec, scheme: Scheme, halo: int) -> tuple:
    """Cache key of one scalar i-query (shared by prefetch fill + lookup)."""
    return (layer, scheme, halo)


def _s_key(layer: LayerSpec, nxt: Optional[LayerSpec], src: Scheme,
           dst: Optional[Scheme]) -> tuple:
    """Cache key of one scalar s-query: ``nxt`` enters only through
    ``(k, fan_in, conv_t)`` — all the feature expression reads from it."""
    return (layer, None if nxt is None else (nxt.k, nxt.fan_in, nxt.conv_t),
            src, dst)


class CostTableBuilder:
    """Two-phase batched evaluation: register unique queries, then resolve
    them all with one ``i_cost_batch`` and one ``s_cost_batch`` call.

    Deduplication keys carry exactly the information the estimator reads —
    repeated blocks (e.g. resnet101's 23 identical bottlenecks) collapse to
    one row.
    """

    def __init__(self, est: CostEstimator, tb: Testbed):
        self._est = est
        self._tb = tb
        self._i_keys: Dict[tuple, int] = {}
        self._i_rows: List[List[float]] = []
        self._i_factors: List[float] = []
        self._s_keys: Dict[tuple, int] = {}
        self._s_rows: List[List[float]] = []
        # dedup accounting: a hit is a registered query that collapsed
        # onto an existing row (plain ints here; pushed to the metrics
        # registry in one batch by evaluate() — see obs.metrics)
        self.i_hits = 0
        self.i_misses = 0
        self.s_hits = 0
        self.s_misses = 0
        self._pushed = {"i_hits": 0, "i_misses": 0,
                        "s_hits": 0, "s_misses": 0}
        # geometric identity per layer *object* (pinned so ids stay unique):
        # the estimator reads only feature_vector() (+ extra_flop_factor),
        # so name-blind keys make repeated blocks share one row
        self._layer_memo: Dict[int, tuple] = {}
        self._pinned: List[LayerSpec] = []

    def layer_key(self, layer: LayerSpec) -> tuple:
        """Name-blind geometric identity of ``layer`` — everything the
        estimators can read.  Layers (and whole branches) with equal keys
        have equal costs and can share rows and DP tables."""
        key = self._layer_memo.get(id(layer))
        if key is None:
            key = (layer.feature_vector(), layer.extra_flop_factor)
            self._layer_memo[id(layer)] = key
            self._pinned.append(layer)
        return key

    def i_index(self, layer: LayerSpec, scheme: Scheme, halo: int) -> int:
        key = (self.layer_key(layer), scheme, halo)
        idx = self._i_keys.get(key)
        if idx is None:
            self.i_misses += 1
            idx = len(self._i_rows)
            self._i_keys[key] = idx
            self._i_rows.append(i_features(layer, scheme, self._tb, halo))
            self._i_factors.append(layer.extra_flop_factor)
        else:
            self.i_hits += 1
        return idx

    def s_index(self, layer: LayerSpec, nxt, src: Scheme, dst) -> int:
        key = (self.layer_key(layer),
               None if nxt is None else (nxt.k, nxt.fan_in, nxt.conv_t),
               src, dst)
        idx = self._s_keys.get(key)
        if idx is None:
            self.s_misses += 1
            idx = len(self._s_rows)
            self._s_keys[key] = idx
            self._s_rows.append(s_features(layer, nxt, src, dst, self._tb))
        else:
            self.s_hits += 1
        return idx

    @property
    def i_entries(self) -> int:
        return len(self._i_rows)

    @property
    def s_entries(self) -> int:
        return len(self._s_rows)

    def evaluate(self, est: Optional[CostEstimator] = None,
                 ivals: Optional[np.ndarray] = None,
                 svals: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Resolve every registered query in two batched estimator calls.

        ``est`` re-evaluates the *same registered rows* under a different
        estimator: registration (the enumeration and dedup phase) depends
        only on graph geometry and the testbed projection, so a capability
        change that leaves ``cluster.compat_testbed()`` intact reuses it.
        ``ivals`` / ``svals`` skip re-evaluating that side entirely and
        return the passed array."""
        est = self._est if est is None else est
        if ivals is None:
            ivals = (est.i_cost_batch(
                np.asarray(self._i_rows, np.float64), self._tb,
                np.asarray(self._i_factors, np.float64))
                if self._i_rows else np.empty(0))
        elif len(ivals) != len(self._i_rows):
            raise ValueError(f"cached ivals cover {len(ivals)} rows, "
                             f"builder has {len(self._i_rows)}")
        if svals is None:
            svals = (est.s_cost_batch(
                np.asarray(self._s_rows, np.float64), self._tb)
                if self._s_rows else np.empty(0))
        elif len(svals) != len(self._s_rows):
            raise ValueError(f"cached svals cover {len(svals)} rows, "
                             f"builder has {len(self._s_rows)}")
        # push dedup deltas since the previous evaluate() in one batch
        # (re-evaluations of a long-lived builder don't double count)
        for attr, name, table in (
                ("i_hits", "cost_tables.dedup_hits", "i"),
                ("i_misses", "cost_tables.dedup_misses", "i"),
                ("s_hits", "cost_tables.dedup_hits", "s"),
                ("s_misses", "cost_tables.dedup_misses", "s")):
            delta = getattr(self, attr) - self._pushed[attr]
            if delta:
                _obs_metrics.inc(name, delta, table=table)
                self._pushed[attr] = getattr(self, attr)
        return np.asarray(ivals, np.float64), np.asarray(svals, np.float64)


def admissible_segments(ls: Sequence[LayerSpec],
                        schemes: Sequence[Scheme], nodes: int, cap: int):
    """Enumerate every admissible NT segment of a chain — the single source
    of the halo-degeneration rule of table building.

    Yields ``(i, pi, seg_queries, halo_cut)`` per segment start and scheme:
    ``seg_queries[L-1]`` lists the ``(layer_index, halo)`` i-queries of
    segment ``[i .. i+L-1]`` (ascending offset, the scalar accumulation
    order); ``halo_cut`` is True when the halo degenerated into full
    replication before ``cap`` was reached.  Non-spatial schemes only admit
    singleton segments (NT is undefined for OutC).
    """
    n = len(ls)
    for i in range(n):
        hi = min(i + cap, n)
        # halo vectors are scheme-independent: compute once per (i, b)
        halos_by_b = {b: halo_growth(ls[i:b + 1], b - i)
                      for b in range(i + 1, hi)}
        for pi, p in enumerate(schemes):
            queries: List[List[Tuple[int, int]]] = [[(i, 0)]]
            halo_cut = False
            if p.spatial:
                ext = min_shard_extent(ls[i], p, nodes)
                for b in range(i + 1, hi):
                    halos = halos_by_b[b]
                    if 2 * halos[0] >= ext:
                        halo_cut = True
                        break   # degenerated into replication
                    queries.append([(i + off, halos[off])
                                    for off in range(b - i + 1)])
            yield i, pi, queries, halo_cut


@dataclasses.dataclass
class ChainTables:
    """Precomputed costs for one chain of layers.

    ``seg[i, pi, L-1]`` is the summed i-cost (halos included) of segment
    ``[i .. i+L-1]`` under ``schemes[pi]``, ``+inf`` where inadmissible
    (non-spatial multi-layer fusion, halo degenerated into replication, or
    beyond ``max_segment``).  Admissible lengths form a prefix per
    ``(i, pi)`` because the halo is monotone in segment length.
    ``sbound[b, pi, qi]`` is the T-boundary s-cost between layers ``b`` and
    ``b+1``; ``s_final[pi]`` the gather-to-root of the last layer (NaN-free
    only when built ``with_final``).
    """

    schemes: Tuple[Scheme, ...]
    seg: np.ndarray
    sbound: np.ndarray
    s_final: np.ndarray
    halo_cuts: int = 0

    @property
    def n(self) -> int:
        return self.seg.shape[0]

    def seg_options(self, i: int, pi: int,
                    head_solo: bool = False) -> List[Tuple[int, float]]:
        """Ascending ``(b, segcost)`` options for segments starting at
        ``i``."""
        if head_solo and i == 0:
            cap = 1
        else:
            cap = min(self.seg.shape[2], self.n - i)
        row = self.seg[i, pi]
        out: List[Tuple[int, float]] = []
        for L in range(cap):
            v = row[L]
            if v == _INF:
                break   # admissible lengths are a prefix
            out.append((i + L, float(v)))
        return out

    def bound(self, b: int, pi: int, qi: int) -> float:
        return float(self.sbound[b, pi, qi])

    def final(self, pi: int) -> float:
        """Gather-to-root s-cost of the last layer (``with_final`` only)."""
        return float(self.s_final[pi])


# ---------------------------------------------------------------------------
# Pareto reductions over (compute, sync) cost pairs.
#
# The throughput objectives carry two accumulators per partial plan — the
# per-request device occupancy (sum of segment i-costs) and link occupancy
# (sum of sync s-costs) — and every composition step in the DP is monotone
# in both, so exact search reduces to nondominated-set propagation.  These
# are the batched primitives: one lexsort + cummin per frontier merge, the
# same numpy-reduction style as the latency DP's argmin scans.
# ---------------------------------------------------------------------------

def pareto_front_2d(a: np.ndarray, b: np.ndarray,
                    ub: float = _INF) -> np.ndarray:
    """Indices of the nondominated (min-``a``, min-``b``) points, sorted by
    ``a`` ascending.  Duplicate values collapse to the first occurrence in
    the input order (the scalar scan's tie-breaking); points with either
    coordinate beyond ``ub`` are dropped (any completion only adds cost, so
    they can never beat an incumbent whose total is ``ub``)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    idx = np.arange(len(a))
    if ub != _INF:
        ok = (a <= ub) & (b <= ub)
        idx = idx[ok]
        if not len(idx):
            return idx
        a, b = a[idx], b[idx]
    order = np.lexsort((idx, b, a))     # a asc, then b asc, then input order
    a_s, b_s = a[order], b[order]
    keep = np.empty(len(order), bool)
    keep[0] = True
    if len(order) > 1:
        cm = np.minimum.accumulate(b_s)
        keep[1:] = b_s[1:] < cm[:-1]
    return idx[order[keep]]


def pareto_front_nd(cols: Sequence[np.ndarray]) -> np.ndarray:
    """Indices of the nondominated rows under elementwise minimisation of
    ``cols`` (pairwise O(m^2) domination — used on the small per-branch
    option tables of the DAG composition, where m stays in the tens)."""
    M = np.stack([np.asarray(c, np.float64) for c in cols], axis=1)
    m = len(M)
    if m <= 1:
        return np.arange(m)
    le = (M[:, None, :] <= M[None, :, :]).all(axis=2)
    lt = (M[:, None, :] < M[None, :, :]).any(axis=2)
    dominated = (le & lt).any(axis=0)
    # drop exact-duplicate rows, keeping the first occurrence
    eq = (M[:, None, :] == M[None, :, :]).all(axis=2)
    first_dup = np.triu(eq, 1).any(axis=0)
    return np.nonzero(~(dominated | first_dup))[0]


def plan_chain_tables(ls: Sequence[LayerSpec], registry: CostTableBuilder,
                      schemes: Sequence[Scheme], max_segment: int,
                      allow_fusion: bool, nodes: int,
                      with_final: bool = True
                      ) -> Callable[[np.ndarray, np.ndarray], ChainTables]:
    """Phase 1: register every admissible segment/boundary query of one
    chain with ``registry``.  Returns a finalizer that assembles the
    :class:`ChainTables` once the registry has been evaluated (several
    chains — e.g. all branches of a DAG — share one registry and thus one
    batched estimator call)."""
    n = len(ls)
    k = len(schemes)
    cap = max(1, min(max_segment, n)) if allow_fusion else 1
    # segment index plans: seg_idx[(i, pi)] = list over L of per-layer row
    # indices (ascending offset — summed in scalar order later)
    seg_idx: Dict[Tuple[int, int], List[List[int]]] = {}
    halo_cuts = 0
    for i, pi, queries, halo_cut in admissible_segments(ls, schemes, nodes,
                                                        cap):
        p = schemes[pi]
        seg_idx[(i, pi)] = [[registry.i_index(ls[m], p, halo)
                             for m, halo in q] for q in queries]
        halo_cuts += halo_cut
    bound_idx = np.empty((max(n - 1, 0), k, k), np.int64)
    for b in range(n - 1):
        for pi, p in enumerate(schemes):
            for qi, q in enumerate(schemes):
                bound_idx[b, pi, qi] = registry.s_index(ls[b], ls[b + 1], p, q)
    final_idx = np.asarray(
        [registry.s_index(ls[-1], None, p, None) for p in schemes]
        if (with_final and n) else [], np.int64)

    def finalize(ivals: np.ndarray, svals: np.ndarray) -> ChainTables:
        seg = np.full((n, k, cap), _INF)
        for (i, pi), rows in seg_idx.items():
            for L, idxs in enumerate(rows):
                c = 0.0
                for idx in idxs:   # scalar accumulation order
                    c += ivals[idx]
                seg[i, pi, L] = c
        sbound = svals[bound_idx] if n > 1 else \
            np.empty((0, k, k), np.float64)
        s_final = svals[final_idx] if final_idx.size else \
            np.full(k, np.nan)
        return ChainTables(tuple(schemes), seg, sbound, s_final, halo_cuts)

    return finalize


def build_chain_tables(ls: Sequence[LayerSpec], est: CostEstimator,
                       tb: Testbed, schemes: Sequence[Scheme],
                       max_segment: int, allow_fusion: bool,
                       with_final: bool = True
                       ) -> Tuple[ChainTables, int, int]:
    """One-chain convenience wrapper: returns ``(tables, i_rows, s_rows)``
    evaluated in a single pair of batched estimator calls."""
    builder = CostTableBuilder(est, tb)
    fin = plan_chain_tables(ls, builder, schemes, max_segment, allow_fusion,
                            tb.nodes, with_final)
    ivals, svals = builder.evaluate()
    return fin(ivals, svals), builder.i_entries, builder.s_entries


class PrefetchedEstimator:
    """``CostEstimator`` view that answers scalar queries from one batched
    prefetch over everything a plan on ``graph`` could ask.

    Used by consumers that still walk plans one cost at a time — the
    exhaustive oracle scoring thousands of candidate plans, and the
    fixed-plan baselines — so their per-query cost drops to a dict lookup.
    Unknown queries fall back to the wrapped estimator (and are cached), so
    the view is always exact.
    """

    def __init__(self, est: CostEstimator, tb: Testbed):
        self._est = est
        self._i: Dict[tuple, float] = {}
        self._s: Dict[tuple, float] = {}
        # plain-int hit/miss counters (the scalar path is called in the
        # oracle's innermost loop — no registry indirection here; read
        # them via cache_info() or push_metrics())
        self.hits = 0
        self.misses = 0

    @classmethod
    def for_graph(cls, graph: ModelGraph, est: CostEstimator, tb: Testbed,
                  schemes: Sequence[Scheme] = ALL_SCHEMES,
                  allow_fusion: bool = True) -> CostEstimator:
        """Prefetch every i/s query reachable by a feasible plan: all
        non-degenerate segments of every branch, all internal boundaries,
        every junction delivery, and the final gather.  Estimators without
        the batched protocol are returned unwrapped (scalar semantics may
        depend on more than the feature expression, e.g. layer names)."""
        if not hasattr(est, "i_cost_batch"):
            return est
        self = cls(est, tb)
        builder = CostTableBuilder(est, tb)
        layers = graph.layers
        i_keys: List[Tuple[tuple, int]] = []
        s_keys: List[Tuple[tuple, int]] = []

        def reg_s(layer, nxt, src, dst):
            s_keys.append((_s_key(layer, nxt, src, dst),
                           builder.s_index(layer, nxt, src, dst)))

        for br in graph.linearize():
            ls = [layers[i] for i in br.ids]
            n = len(ls)
            cap = n if allow_fusion else 1
            for _, pi, queries, _ in admissible_segments(ls, schemes,
                                                         tb.nodes, cap):
                p = schemes[pi]
                for q in queries:
                    for m, halo in q:
                        i_keys.append((_i_key(ls[m], p, halo),
                                       builder.i_index(ls[m], p, halo)))
            for b in range(n - 1):
                for p in schemes:
                    for q in schemes:
                        reg_s(ls[b], ls[b + 1], p, q)
            tail = ls[-1]
            consumers = graph.consumer_ids[br.ids[-1]]
            if not consumers:
                for p in schemes:
                    reg_s(tail, None, p, None)
            for c in consumers:
                for p in schemes:
                    for q in schemes:
                        reg_s(tail, layers[c], p, q)

        ivals, svals = builder.evaluate()
        for key, idx in i_keys:
            self._i[key] = float(ivals[idx])
        for key, idx in s_keys:
            self._s[key] = float(svals[idx])
        return self

    # ---- CostEstimator protocol ------------------------------------------
    def i_cost(self, layer: LayerSpec, scheme: Scheme, tb: Testbed,
               extra_halo: int = 0) -> float:
        key = _i_key(layer, scheme, extra_halo)
        hit = self._i.get(key)
        if hit is None:
            self.misses += 1
            hit = self._est.i_cost(layer, scheme, tb, extra_halo=extra_halo)
            self._i[key] = hit
        else:
            self.hits += 1
        return hit

    def s_cost(self, layer: LayerSpec, nxt: Optional[LayerSpec], src: Scheme,
               dst: Optional[Scheme], tb: Testbed) -> float:
        key = _s_key(layer, nxt, src, dst)
        hit = self._s.get(key)
        if hit is None:
            self.misses += 1
            hit = self._est.s_cost(layer, nxt, src, dst, tb)
            self._s[key] = hit
        else:
            self.hits += 1
        return hit

    def cache_info(self) -> Tuple[int, int]:
        """(hits, misses) of the scalar lookup path."""
        return (self.hits, self.misses)

    def push_metrics(self) -> None:
        """Batch the counters into the installed metrics registry (a
        no-op without one)."""
        _obs_metrics.inc("prefetch.hits", self.hits)
        _obs_metrics.inc("prefetch.misses", self.misses)

    def i_cost_batch(self, X: np.ndarray, tb: Testbed,
                     flop_factor: Optional[np.ndarray] = None) -> np.ndarray:
        return self._est.i_cost_batch(X, tb, flop_factor)

    def s_cost_batch(self, X: np.ndarray, tb: Testbed) -> np.ndarray:
        return self._est.s_cost_batch(X, tb)
