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

A trimmed copy of the JAX package's ``core/estimator.py``: the data-driven
``GBDTEstimator`` and its prediction caches are left out.
"""
from __future__ import annotations

from typing import List, Optional, Protocol, Sequence

import numpy as np

from .cost import (Testbed, compute_time_batch_s, compute_time_s,
                   sync_time_batch_s, sync_time_s)
from .graph import LayerSpec
from .partition import Scheme


class CostEstimator(Protocol):
    """Scalar estimator protocol — the minimum every estimator provides.

    The planner additionally needs the batched entry points of
    :class:`BatchedCostEstimator`."""

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
    """17-column i-feature row; ``hetero`` (a :func:`testbed_summary`-style
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


def testbed_summary(tb: Testbed) -> List[float]:
    """Capability summary (:data:`HETERO_FEATURE_NAMES`) of the uniform
    cluster a ``Testbed`` describes — what homogeneous trace rows carry in
    a hetero-width matrix."""
    share = 1.0 / tb.nodes
    return [share, share, share, 1.0, latency_class(tb.link_latency_us)]
