"""Cost estimator (CE) interface — i-Estimator and s-Estimator (§3.2).

:class:`AnalyticEstimator` wraps the closed-form testbed model
(``core/cost.py``); it is the Theorem-1 oracle and the label source for
trace generation.

Feature expression (Fig. 4, extended with the planner's decision variables,
the DAG fan-in so the estimators see merge structure, and the ATTN head
count so they see head-granular OutC geometry):
``[InH, InW, InC, OutH, OutW, OutC, K, S, P, ConvT, FanIn, Heads,
bandwidth, topology]`` plus ``nodes, scheme, halo`` for i- and ``nodes,
src, dst, next_K, next_fan_in, next_conv_t`` for s-.  Rows may append
the :data:`HETERO_FEATURE_NAMES` per-cluster capability summary after the
exact homogeneous prefix.

:class:`GBDTEstimator` is the paper's data-driven estimator: two GBDT
regressors (``repro_torch.gbdt``, forests on the card unless fit or loaded
with ``device="cpu"``) trained on traces from ``repro_torch.sim.trace``;
they predict log-seconds, and the estimator takes ``np.exp`` on the host
after one copy back, so its costs equal the JAX package's whenever the
forests' predictions do.

A copy of the JAX package's ``core/estimator.py``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Protocol, Sequence, Tuple

import numpy as np

from .cost import (Testbed, compute_time_batch_s, compute_time_s,
                   sync_time_batch_s, sync_time_s)
from .graph import LayerSpec
from .partition import Scheme


class CostEstimator(Protocol):
    """Scalar estimator protocol — the minimum every estimator provides.

    Estimators may additionally implement :class:`BatchedCostEstimator`;
    consumers feature-test with ``hasattr(est, "i_cost_batch")`` and fall
    back to scalar-call paths otherwise (scalar-only estimators may depend
    on information outside the feature expression, e.g. layer names)."""

    def i_cost(self, layer: LayerSpec, scheme: Scheme, tb: Testbed,
               extra_halo: int = 0) -> float: ...

    def s_cost(self, layer: LayerSpec, nxt: Optional[LayerSpec], src: Scheme,
               dst: Optional[Scheme], tb: Testbed) -> float: ...


class BatchedCostEstimator(CostEstimator, Protocol):
    """Batched extension: costs are determined by the feature expression
    alone, and whole query matrices evaluate in one call, bit-identical to
    the scalar protocol row for row."""

    def i_cost_batch(self, X: np.ndarray, tb: Testbed,
                     flop_factor: Optional[np.ndarray] = None
                     ) -> np.ndarray:
        """Vector i-Estimator over a stacked ``(n, 17)`` matrix of
        :func:`i_features` rows.  Row ``j`` must equal
        ``i_cost(layer_j, scheme_j, tb_j, halo_j)`` exactly.
        ``flop_factor`` carries ``extra_flop_factor`` per row for estimators
        that read the analytic physics (it is not a learned feature)."""
        ...

    def s_cost_batch(self, X: np.ndarray, tb: Testbed) -> np.ndarray:
        """Vector s-Estimator over stacked ``(n, 20)`` :func:`s_features`
        rows (``Dst = -1`` marks the final gather)."""
        ...


class AnalyticEstimator:
    """Oracle estimator: reads the simulated testbed physics directly."""

    def i_cost(self, layer: LayerSpec, scheme: Scheme, tb: Testbed,
               extra_halo: int = 0) -> float:
        return compute_time_s(layer, scheme, tb, extra_halo=extra_halo)

    def s_cost(self, layer: LayerSpec, nxt: Optional[LayerSpec], src: Scheme,
               dst: Optional[Scheme], tb: Testbed) -> float:
        return sync_time_s(layer, nxt, src, dst, tb)

    def i_cost_batch(self, X: np.ndarray, tb: Testbed,
                     flop_factor: Optional[np.ndarray] = None
                     ) -> np.ndarray:
        return compute_time_batch_s(X, tb, flop_factor)

    def s_cost_batch(self, X: np.ndarray, tb: Testbed) -> np.ndarray:
        return sync_time_batch_s(X, tb)


# ---------------------------------------------------------------------------
# Feature extraction shared by the cost tables and the estimators.
# ---------------------------------------------------------------------------

def i_features(layer: LayerSpec, scheme: Scheme, tb: Testbed,
               extra_halo: int,
               hetero: Optional[Sequence[float]] = None) -> List[float]:
    """17-column i-feature row; ``hetero`` (a :func:`hetero_summary`
    list) appends the per-cluster capability columns after the exact
    homogeneous prefix."""
    row = [*layer.feature_vector(), tb.bandwidth_gbps, float(tb.topology),
           float(tb.nodes), float(scheme), float(extra_halo)]
    if hetero is not None:
        row.extend(hetero)
    return row


def s_features(layer: LayerSpec, nxt: Optional[LayerSpec], src: Scheme,
               dst: Optional[Scheme], tb: Testbed,
               hetero: Optional[Sequence[float]] = None) -> List[float]:
    row = [*layer.feature_vector(), tb.bandwidth_gbps, float(tb.topology),
           float(tb.nodes), float(src),
           -1.0 if dst is None else float(dst),
           0.0 if nxt is None else float(nxt.k),
           0.0 if nxt is None else float(nxt.fan_in),
           0.0 if nxt is None else float(nxt.conv_t)]
    if hetero is not None:
        row.extend(hetero)
    return row


I_FEATURE_NAMES = ["InH", "InW", "InC", "OutH", "OutW", "OutC", "K", "S", "P",
                   "ConvT", "FanIn", "Heads", "BW", "Topo", "Nodes", "Scheme",
                   "Halo"]
S_FEATURE_NAMES = ["InH", "InW", "InC", "OutH", "OutW", "OutC", "K", "S", "P",
                   "ConvT", "FanIn", "Heads", "BW", "Topo", "Nodes", "Src",
                   "Dst", "NextK", "NextFanIn", "NextConvT"]

#: per-cluster capability summary appended by the hetero-aware expression
HETERO_FEATURE_NAMES = ["CapMin", "CapMean", "CapMax", "LinkRatio",
                        "LatClass"]
N_HETERO_FEATURES = len(HETERO_FEATURE_NAMES)
I_FEATURE_NAMES_HETERO = I_FEATURE_NAMES + HETERO_FEATURE_NAMES
S_FEATURE_NAMES_HETERO = S_FEATURE_NAMES + HETERO_FEATURE_NAMES


def latency_class(latency_us: float) -> float:
    """Coarse link-latency bucket: 0 = on-board/switched (<= 15us),
    1 = LAN-grade (<= 75us), 2 = constrained uplink.  A discrete class
    (rather than the raw microseconds) keeps the learned trees from
    splitting on measurement jitter."""
    if latency_us <= 15.0:
        return 0.0
    if latency_us <= 75.0:
        return 1.0
    return 2.0


def hetero_summary(capability_weights: Sequence[float],
                   link_bandwidths_gbps: Sequence[float],
                   max_latency_us: float) -> List[float]:
    """Per-cluster capability summary columns (:data:`HETERO_FEATURE_NAMES`).

    ``capability_weights`` is ``gflops * eff_derate`` per device
    (``ClusterSpec.capability_weights``) — the summary carries each
    device's *share* of the total, so the columns are scale-free:
    a uniform cluster reads ``(1/n, 1/n, 1/n, 1.0, class)``.  Plain
    sequences keep ``core`` import-cycle free of ``repro_torch.cluster``.
    """
    w = np.asarray(capability_weights, np.float64)
    if w.size == 0 or np.any(w <= 0.0):
        raise ValueError("capability weights must be positive")
    shares = w / w.sum()
    bws = np.asarray(link_bandwidths_gbps, np.float64)
    ratio = float(bws.min() / bws.max()) if bws.size else 1.0
    return [float(shares.min()), float(shares.mean()), float(shares.max()),
            ratio, latency_class(max_latency_us)]


def testbed_summary(tb: Testbed) -> List[float]:
    """:func:`hetero_summary` of the uniform cluster a ``Testbed``
    describes — what homogeneous trace rows carry in a hetero-width
    matrix."""
    share = 1.0 / tb.nodes
    return [share, share, share, 1.0, latency_class(tb.link_latency_us)]


class _LRUCache:
    """Bounded scalar-prediction cache (plain LRU on an ``OrderedDict``).

    The scalar estimator paths key on ``(layer, scheme, tb, ...)`` tuples;
    a long-lived serving process sees an unbounded stream of distinct
    testbeds/layers, so the cache must evict."""

    __slots__ = ("maxsize", "hits", "misses", "_data")

    def __init__(self, maxsize: int):
        if maxsize < 1:
            raise ValueError(f"cache maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self.hits = 0
        self.misses = 0
        self._data: "OrderedDict" = OrderedDict()

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key) -> Optional[float]:
        hit = self._data.get(key)
        if hit is None:
            self.misses += 1
            return None
        self._data.move_to_end(key)
        self.hits += 1
        return hit

    def put(self, key, value: float) -> None:
        self._data[key] = value
        if len(self._data) > self.maxsize:
            self._data.popitem(last=False)

    def clear(self) -> None:
        self._data.clear()


class GBDTEstimator:
    """Data-driven CE backed by two trained GBDT regressors (log-seconds).

    The scalar protocol memoizes per-query predictions in LRU caches
    bounded at ``cache_size`` entries each (the batched protocol never
    touches them); ``cache_info()`` mirrors
    ``cost_tables.PrefetchedEstimator``.  A scalar call walks the forest
    for one row (a few dozen small launches on a device forest): the
    planner's tables and the oracles' prefetch use the batched calls."""

    def __init__(self, i_model, s_model, cache_size: int = 4096):
        self.i_model = i_model
        self.s_model = s_model
        self._i_cache = _LRUCache(cache_size)
        self._s_cache = _LRUCache(cache_size)

    def cache_info(self) -> Tuple[int, int]:
        """(hits, misses) of the scalar lookup paths, both caches."""
        return (self._i_cache.hits + self._s_cache.hits,
                self._i_cache.misses + self._s_cache.misses)

    def clear_cache(self) -> None:
        self._i_cache.clear()
        self._s_cache.clear()

    def i_cost(self, layer: LayerSpec, scheme: Scheme, tb: Testbed,
               extra_halo: int = 0) -> float:
        key = (layer, scheme, tb, extra_halo)
        hit = self._i_cache.get(key)
        if hit is None:
            x = np.asarray([i_features(layer, scheme, tb, extra_halo)],
                           dtype=np.float64)
            hit = float(np.exp(self.i_model.predict(x)[0]))
            self._i_cache.put(key, hit)
        return hit

    def s_cost(self, layer: LayerSpec, nxt: Optional[LayerSpec], src: Scheme,
               dst: Optional[Scheme], tb: Testbed) -> float:
        key = (layer,
               None if nxt is None else (nxt.k, nxt.fan_in, nxt.conv_t),
               src, dst, tb)
        hit = self._s_cache.get(key)
        if hit is None:
            x = np.asarray([s_features(layer, nxt, src, dst, tb)],
                           dtype=np.float64)
            hit = float(np.exp(self.s_model.predict(x)[0]))
            self._s_cache.put(key, hit)
        return hit

    def i_cost_batch(self, X: np.ndarray, tb: Testbed,
                     flop_factor: Optional[np.ndarray] = None
                     ) -> np.ndarray:
        """One forest pass for the whole matrix (``flop_factor`` is not part
        of the learned feature expression and is ignored, exactly as the
        scalar path ignores it)."""
        return np.exp(self.i_model.predict(np.asarray(X, np.float64)))

    def s_cost_batch(self, X: np.ndarray, tb: Testbed) -> np.ndarray:
        return np.exp(self.s_model.predict(np.asarray(X, np.float64)))
