"""Online calibration — fold measurements back into the planner's costs.

The learned and analytic estimators price a plan from first principles;
the machine (or the discrete-event simulator standing in for it) reports
what actually happened.  This module closes that loop with two small,
composable correctors:

* :class:`OnlineCalibrator` — a per-device multiplicative residual model.
  ``predicted_occupancy`` prices a plan's per-device / per-link busy
  seconds from the same stage decomposition the simulator executes
  (``simsched.build_stages``), so a measurement and its prediction are
  term-for-term comparable.  ``observe`` folds a measurement —
  a :class:`~repro_torch.cluster.simsched.SimReport` or any
  scalar-occupancy object shaped like ``ExecStats.to_occupancy()``
  (``dev_occupancy_s`` / ``link_occupancy_s`` / ``period_s``, optional
  ``failures``) — into
  exponentially-weighted per-device compute corrections and a scalar sync
  correction.  ``axis_scales()`` exports the corrections in exactly the
  ``(beta, alpha)`` form ``refine_with_simulator`` re-weights the cached
  frontier with (the JAX package's ``ClusterGBDTEstimator`` also consumes
  it to correct learned costs at call time; the port has no GBDT yet).

* :func:`fold_queueing_delay` — the serving-side correction: the
  analytic ``P99_BOUNDED`` objective bounds *service* latency, but an
  open arrival process adds queueing delay the per-request model cannot
  see.  Given measured ``sweep_serving`` rows, it subtracts the measured
  queueing-delay curve (interpolated at the target arrival rate) from
  the p99 bound, so the planner's analytic constraint lands where the
  measured tail actually sits.

A copy of the JAX package's ``cluster/calibrate.py``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import ModelGraph
from repro_torch.core.plan import Plan

from .simsched import SimReport, build_stages
from .spec import ClusterSpec


@dataclasses.dataclass(frozen=True)
class CalibrationSample:
    """One folded measurement: what was predicted, what was measured,
    and the correction state after the update."""

    plan_signature: Tuple[Tuple[int, int], ...]   # (scheme, mode) per layer
    predicted_period_s: float
    measured_period_s: float
    trusted: bool
    compute_scale: Tuple[float, ...]
    sync_scale: float


class OnlineCalibrator:
    """Per-device multiplicative residual corrector (EMA over samples).

    ``compute_scale[d]`` multiplies every compute-second prediction for
    device ``d``; ``sync_scale`` multiplies every link-second prediction.
    Scales start at 1.0 (no correction) and move toward each measured
    measured-over-predicted ratio with weight ``decay`` per observation
    (``decay=1.0`` trusts the newest sample outright, small values
    smooth over measurement noise).

    Trust: a measurement with a nonzero ``failures`` attribute (the
    mesh executor's retry/timeout/fallback counter surfaced by
    ``ExecStats.to_occupancy()``) is recorded in the history but does not
    move the scales — the same untrusted-sample rule
    ``refine_with_simulator`` applies.
    """

    def __init__(self, cluster: ClusterSpec, decay: float = 0.5):
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self.cluster = cluster
        self.decay = decay
        self.compute_scale = np.ones(cluster.n, np.float64)
        self.sync_scale = 1.0
        self.history: List[CalibrationSample] = []

    # ---- prediction -------------------------------------------------------
    def predicted_occupancy(self, graph: ModelGraph, plan: Plan,
                            weighted: bool = True, batch_size: int = 1
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """Uncorrected per-device / per-link busy seconds of one request —
        the sums ``simulate`` accumulates into ``device_busy_s`` /
        ``link_busy_s``, priced without running the event loop."""
        dev = np.zeros(self.cluster.n, np.float64)
        link = np.zeros(len(self.cluster.links), np.float64)
        for st in build_stages(graph, plan, self.cluster, weighted=weighted,
                               batch_size=batch_size):
            if st.kind == "compute":
                dev += np.asarray(st.durations, np.float64)
            else:
                link += np.asarray(st.durations, np.float64)
        return dev, link

    def predict_period(self, graph: ModelGraph, plan: Plan,
                       weighted: bool = True, batch_size: int = 1) -> float:
        """Corrected steady-state period bound: the busiest corrected
        resource paces the pipeline."""
        dev, link = self.predicted_occupancy(graph, plan, weighted,
                                             batch_size)
        busiest_dev = float(np.max(dev * self.compute_scale)) if dev.size \
            else 0.0
        busiest_link = float(np.max(link)) * self.sync_scale if link.size \
            else 0.0
        return max(busiest_dev, busiest_link)

    def axis_scales(self) -> Tuple[float, float]:
        """``(beta, alpha)`` for frontier re-selection: the straggler-side
        compute correction and the sync correction (capability-weighted
        shards equalize per-device time, so the post-correction straggler
        is the device with the largest correction)."""
        return float(np.max(self.compute_scale)), float(self.sync_scale)

    # ---- measurement folding ----------------------------------------------
    def observe(self, graph: ModelGraph, plan: Plan, measured,
                weighted: bool = True, batch_size: int = 1) -> bool:
        """Fold one measurement; returns ``True`` when the sample was
        trusted (scales moved).

        ``measured`` is either a :class:`SimReport` (per-device busy
        vectors divide by ``n_requests``) or a scalar-occupancy object
        (``dev_occupancy_s`` / ``link_occupancy_s`` / ``period_s``),
        whose bottleneck ratios apply at the predicted straggler device /
        busiest link — a scalar probe cannot localize the residual, so it
        corrects where the prediction says the bottleneck is.
        """
        dev, link = self.predicted_occupancy(graph, plan, weighted,
                                             batch_size)
        pred_period = max(float(np.max(dev)) if dev.size else 0.0,
                          float(np.max(link)) if link.size else 0.0)
        if isinstance(measured, SimReport):
            served = max(measured.n_requests, 1)
            m_dev = np.asarray(measured.device_busy_s, np.float64) / served
            m_link = np.asarray(measured.link_busy_s, np.float64) / served
            trusted = True
            meas_period = (1.0 / measured.throughput_rps
                           if measured.throughput_rps > 0.0 else 0.0)
            dev_ratio = np.where(dev > 0.0, m_dev / np.maximum(dev, 1e-30),
                                 1.0)
            link_max = float(np.max(m_link)) if m_link.size else 0.0
            pred_link_max = float(np.max(link)) if link.size else 0.0
            sync_ratio = (link_max / pred_link_max
                          if pred_link_max > 0.0 else 1.0)
        else:
            trusted = getattr(measured, "failures", 0) == 0
            meas_period = float(measured.period_s)
            dev_ratio = np.ones_like(dev)
            straggler = int(np.argmax(dev)) if dev.size else 0
            if dev.size and dev[straggler] > 0.0:
                dev_ratio[straggler] = \
                    float(measured.dev_occupancy_s) / dev[straggler]
            pred_link_max = float(np.max(link)) if link.size else 0.0
            sync_ratio = (float(measured.link_occupancy_s) / pred_link_max
                          if pred_link_max > 0.0 else 1.0)
        if trusted:
            self.compute_scale = ((1.0 - self.decay) * self.compute_scale
                                  + self.decay * dev_ratio)
            self.sync_scale = ((1.0 - self.decay) * self.sync_scale
                               + self.decay * sync_ratio)
        self.history.append(CalibrationSample(
            plan_signature=tuple((int(s), int(m)) for s, m in plan.steps),
            predicted_period_s=pred_period,
            measured_period_s=meas_period,
            trusted=trusted,
            compute_scale=tuple(float(x) for x in self.compute_scale),
            sync_scale=float(self.sync_scale)))
        return trusted


def fold_queueing_delay(p99_bound_s: float, rows: Sequence[dict],
                        arrival_rate_rps: float,
                        service_p99_s: Optional[float] = None) -> float:
    """Tighten an analytic p99 bound by the measured queueing delay.

    ``rows`` are measured ``sweep_serving`` rows (the BENCH_serving
    record format).  The queueing-delay curve is each row's p99 in excess
    of the service-only tail — ``service_p99_s`` when the caller knows it
    (e.g. a closed-loop single-request run), else the minimum measured
    p99 across the sweep (the lightest-load row, where queueing is
    negligible).  The curve is interpolated at ``arrival_rate_rps``
    (clamped to the measured range) and subtracted from the bound,
    floored at zero; the result is what ``Objective.P99_BOUNDED``'s
    ``latency_bound_s`` should be so the *measured* tail meets the
    original bound under that arrival rate.
    """
    if p99_bound_s <= 0.0:
        raise ValueError(f"p99 bound must be positive, got {p99_bound_s}")
    if not rows:
        return p99_bound_s
    rates = np.asarray([float(r["arrival_rate_rps"]) for r in rows])
    p99s = np.asarray([float(r["p99_ms"]) * 1e-3 for r in rows])
    order = np.argsort(rates)
    rates, p99s = rates[order], p99s[order]
    base = float(np.min(p99s)) if service_p99_s is None \
        else float(service_p99_s)
    delays = np.maximum(p99s - base, 0.0)
    delay = float(np.interp(arrival_rate_rps, rates, delays))
    return max(p99_bound_s - delay, 0.0)
