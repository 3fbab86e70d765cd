"""Cluster-bound analytic cost estimator (batched protocol).

``ClusterAnalyticEstimator`` is the heterogeneous counterpart of
``repro_torch.core.AnalyticEstimator``: i-costs are straggler times over
capability-weighted per-device compute (``core.cost.hetero_compute_time_s``),
s-costs are the busiest-link bound over the cluster's per-edge graph
(``sync_time_s`` against the bottleneck-projected compat testbed).  It
implements the full batched protocol, so ``plan_search`` and the cost
tables drive it through one ``i_cost_batch``/``s_cost_batch`` pair — no
scalar fallback on heterogeneous layouts.

``weighted=False`` keeps the same silicon but shards evenly (uniform
weights), which is the homogeneous-assumption baseline the sweep compares
capability-weighted plans against: even splits leave the slow device
straggling on every layer.

A trimmed copy of the JAX package's ``cluster/estimator.py``: the learned
``ClusterGBDTEstimator`` is left out until the port has the GBDT.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.cost import (Testbed, hetero_compute_time_batch_s,
                             hetero_compute_time_s, hetero_device_times_s,
                             sync_time_batch_s, sync_time_s)
from repro_torch.core.graph import LayerSpec
from repro_torch.core.partition import Scheme

from .spec import ClusterSpec


class ClusterAnalyticEstimator:
    """Analytic CE bound to one :class:`ClusterSpec`.

    The ``tb`` argument of the estimator protocol must agree with the
    cluster's node count (pass ``cluster.compat_testbed()`` to the planner);
    scheme efficiencies / bottleneck link always come from the cluster.
    """

    def __init__(self, cluster: ClusterSpec, weighted: bool = True):
        self.cluster = cluster
        self.weighted = weighted
        self._tb = cluster.compat_testbed()
        self._speeds = cluster.speeds_gflops
        self._derates = cluster.dev_derates
        self._weights = (cluster.capability_weights if weighted
                         else (1.0,) * cluster.n)

    def _check(self, tb: Testbed) -> None:
        if tb != self._tb:
            raise ValueError(
                f"testbed {tb} does not match the cluster projection "
                f"{self._tb}; pass cluster.compat_testbed() to the planner "
                f"(for what-if sweeps, modify the ClusterSpec, not the "
                f"testbed)")

    # ---- scalar protocol --------------------------------------------------
    def i_cost(self, layer: LayerSpec, scheme: Scheme, tb: Testbed,
               extra_halo: int = 0) -> float:
        self._check(tb)
        return hetero_compute_time_s(layer, scheme, self._tb, self._speeds,
                                     self._derates, self._weights,
                                     extra_halo=extra_halo)

    def s_cost(self, layer: LayerSpec, nxt: Optional[LayerSpec], src: Scheme,
               dst: Optional[Scheme], tb: Testbed) -> float:
        self._check(tb)
        return sync_time_s(layer, nxt, src, dst, self._tb)

    # ---- batched protocol -------------------------------------------------
    def i_cost_batch(self, X: np.ndarray, tb: Testbed,
                     flop_factor: Optional[np.ndarray] = None) -> np.ndarray:
        self._check(tb)
        return hetero_compute_time_batch_s(
            X, self._tb, np.asarray(self._speeds),
            np.asarray(self._derates), np.asarray(self._weights),
            flop_factor)

    def s_cost_batch(self, X: np.ndarray, tb: Testbed) -> np.ndarray:
        self._check(tb)
        return sync_time_batch_s(X, self._tb)

    # ---- simulator hooks --------------------------------------------------
    def device_times(self, layer: LayerSpec, scheme: Scheme,
                     extra_halo: int = 0) -> np.ndarray:
        """Per-device compute seconds (straggler max == :meth:`i_cost`)."""
        return hetero_device_times_s(layer, scheme, self._tb, self._speeds,
                                     self._derates, self._weights,
                                     extra_halo=extra_halo)
