"""Measured-vs-simulated skew: structural trace diffs + per-stage ratios.

Two entry points:

* :func:`stage_skew` consumes the per-stage
  ``{"kind", "label", "sim_s", "measured_s"}`` pairing produced by
  ``runtime.mesh_exec.validate_stage_decomposition`` and reduces it to
  per-stage ``measured/sim`` ratios plus summary statistics;
* :func:`diff_traces` structurally diffs two Perfetto traces in the
  shared schema (a measured mesh trace vs the exported simulated
  timeline): same ``cat="stage"`` span names in the same order, with
  paired durations.

Ratios are **advisory by construction** — the measured side runs the
nodes as streams of one card driven by one host (one after another on
the CPU), the simulated side on the analytic edge-silicon model — so the
summary favours shape-robust statistics (median ratio, max |log2 ratio|)
over means.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

from . import trace as _trace


def stage_skew(stages: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-stage measured/simulated skew from validated stage pairs.

    Stages where either side is missing or non-positive pair as
    ``ratio: None`` and are excluded from the summary (a zero-cost sync
    on one side carries no timing signal)."""
    per: List[Dict[str, Any]] = []
    ratios: List[float] = []
    for st in stages:
        sim = st.get("sim_s")
        meas = st.get("measured_s")
        ratio: Optional[float] = None
        if sim and meas and sim > 0.0 and meas > 0.0:
            ratio = float(meas) / float(sim)
            ratios.append(ratio)
        per.append({"kind": st.get("kind"), "label": st.get("label"),
                    "sim_s": sim, "measured_s": meas, "ratio": ratio})
    summary: Dict[str, Any] = {"n_stages": len(per),
                               "n_paired": len(ratios)}
    if ratios:
        s = sorted(ratios)
        mid = len(s) // 2
        median = s[mid] if len(s) % 2 else 0.5 * (s[mid - 1] + s[mid])
        summary.update(
            median_ratio=float(median),
            min_ratio=float(s[0]),
            max_ratio=float(s[-1]),
            max_abs_log2=float(max(abs(math.log2(r)) for r in ratios)))
    else:
        summary.update(median_ratio=None, min_ratio=None,
                       max_ratio=None, max_abs_log2=None)
    return {"per_stage": per, **summary}


def diff_traces(measured: Dict[str, Any], simulated: Dict[str, Any],
                cat: str = _trace.STAGE_CAT,
                measured_pid: Optional[int] = None,
                simulated_pid: Optional[int] = None) -> Dict[str, Any]:
    """Structural diff of two loaded traces sharing the span schema.

    Compares the ordered ``cat`` span-name sequences (deduplicated to
    first occurrence per name so per-device repetitions of one stage
    collapse) and pairs durations by name.  ``structure_match`` is True
    when both traces contain exactly the same stage names in the same
    first-occurrence order."""
    def names_and_durs(trace_obj, pid):
        evs = _trace.span_events(trace_obj, cat=cat, pid=pid)
        order: List[str] = []
        durs: Dict[str, float] = {}
        for ev in evs:
            n = ev["name"]
            if n not in durs:
                order.append(n)
                durs[n] = 0.0
            durs[n] = max(durs[n], float(ev.get("dur", 0.0)))
        return order, durs

    m_order, m_durs = names_and_durs(measured, measured_pid)
    s_order, s_durs = names_and_durs(simulated, simulated_pid)
    only_measured = [n for n in m_order if n not in s_durs]
    only_simulated = [n for n in s_order if n not in m_durs]
    pairs = [{"name": n, "measured_us": m_durs[n],
              "simulated_us": s_durs[n],
              "ratio": (m_durs[n] / s_durs[n]
                        if s_durs[n] > 0.0 and m_durs[n] > 0.0
                        else None)}
             for n in m_order if n in s_durs]
    return {
        "structure_match": m_order == s_order,
        "only_measured": only_measured,
        "only_simulated": only_simulated,
        "pairs": pairs,
    }
