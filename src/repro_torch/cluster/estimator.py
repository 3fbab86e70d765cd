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

``ClusterGBDTEstimator`` is the learned counterpart: a hetero-trained
``GBDTEstimator`` bound to one cluster.

A copy of the JAX package's ``cluster/estimator.py``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.cost import (Testbed, hetero_compute_time_batch_s,
                             hetero_compute_time_s, hetero_device_times_s,
                             sync_time_batch_s, sync_time_s)
from repro_torch.core.estimator import (GBDTEstimator, N_HETERO_FEATURES,
                                        hetero_summary, i_features,
                                        s_features)
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


class ClusterGBDTEstimator:
    """Learned CE bound to one :class:`ClusterSpec` (batched protocol).

    Wraps a hetero-trained :class:`repro_torch.core.GBDTEstimator` —
    forests fit on traces with the capability-summary columns
    (``sim.trace.hetero_trace_config``) — and appends **this** cluster's
    summary to every 17/20-column row the cost tables build, so
    ``plan_search`` and ``pipeline_frontier`` run on learned costs over
    mixed clusters with zero call-site changes: the first-class
    ``BatchedCostEstimator`` the frontier DP drives.

    ``calibration`` optionally attaches an online residual corrector
    (``cluster.calibrate.OnlineCalibrator``): predictions are multiplied
    by its current correction factors at call time — the straggler-side
    maximum of the per-device compute corrections for i-costs, the sync
    correction for s-costs (capability-weighted shards equalize per-device
    time by construction, so the post-correction straggler is the device
    with the largest correction factor).
    """

    def __init__(self, est: GBDTEstimator, cluster: ClusterSpec,
                 calibration: Optional[object] = None):
        self.base = est
        self.cluster = cluster
        self.calibration = calibration
        self._tb = cluster.compat_testbed()
        self._summary = np.asarray(
            hetero_summary(cluster.capability_weights,
                           [link.bandwidth_gbps for link in cluster.links],
                           cluster.max_latency_us), np.float64)
        width = getattr(est.i_model, "n_features_", None)
        if width is not None and width != 17 + N_HETERO_FEATURES:
            raise ValueError(
                f"i-forest was fit on {width} features, expected "
                f"{17 + N_HETERO_FEATURES} (train with a hetero trace "
                f"config — sim.trace.hetero_trace_config())")

    def _check(self, tb: Testbed) -> None:
        if tb != self._tb:
            raise ValueError(
                f"testbed {tb} does not match the cluster projection "
                f"{self._tb}; pass cluster.compat_testbed() to the planner")

    def _scales(self) -> tuple:
        cal = self.calibration
        if cal is None:
            return 1.0, 1.0
        return (float(np.max(np.asarray(cal.compute_scale, np.float64))),
                float(cal.sync_scale))

    def _extend(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float64)
        cols = np.broadcast_to(self._summary,
                               (len(X), self._summary.size))
        return np.concatenate([X, cols], axis=1)

    # ---- scalar protocol --------------------------------------------------
    def i_cost(self, layer: LayerSpec, scheme: Scheme, tb: Testbed,
               extra_halo: int = 0) -> float:
        self._check(tb)
        x = np.asarray([i_features(layer, scheme, self._tb, extra_halo,
                                   hetero=list(self._summary))], np.float64)
        return float(np.exp(self.base.i_model.predict(x)[0])) \
            * self._scales()[0]

    def s_cost(self, layer: LayerSpec, nxt: Optional[LayerSpec], src: Scheme,
               dst: Optional[Scheme], tb: Testbed) -> float:
        self._check(tb)
        x = np.asarray([s_features(layer, nxt, src, dst, self._tb,
                                   hetero=list(self._summary))], np.float64)
        return float(np.exp(self.base.s_model.predict(x)[0])) \
            * self._scales()[1]

    # ---- batched protocol -------------------------------------------------
    def i_cost_batch(self, X: np.ndarray, tb: Testbed,
                     flop_factor: Optional[np.ndarray] = None) -> np.ndarray:
        """One forest pass over the widened matrix (``flop_factor`` is not
        part of the learned feature expression and is ignored, as in the
        homogeneous ``GBDTEstimator``)."""
        self._check(tb)
        t = np.exp(self.base.i_model.predict(self._extend(X)))
        return t * self._scales()[0]

    def s_cost_batch(self, X: np.ndarray, tb: Testbed) -> np.ndarray:
        self._check(tb)
        t = np.exp(self.base.s_model.predict(self._extend(X)))
        return t * self._scales()[1]
