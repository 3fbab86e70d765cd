"""Unified observability: span tracing, metrics, flight recorder, logs.

The port's copy of the JAX package's ``repro.obs`` (pure Python; the
names, environment variables, track names and trace schema are the
reference's, so traces, snapshots and postmortems compare equal).
Zero-dependency and off by default — installing nothing costs nothing
(see the zero-overhead contract in :mod:`repro_torch.obs.trace`).  A
typical instrumented session:

    from repro_torch import obs

    tracer = obs.set_tracer(obs.Tracer())
    metrics = obs.set_metrics(obs.Metrics())
    obs.set_postmortem_dir("artifacts/")
    ...  # run planner / mesh executor / refinement
    obs.write_trace("trace.json", tracer)
    metrics.export("metrics.json")
    obs.set_tracer(None); obs.set_metrics(None)

Submodules: :mod:`.trace` (spans + Perfetto export), :mod:`.metrics`
(counters/gauges/histograms), :mod:`.flight` (ring buffer +
postmortems), :mod:`.log` (``REPRO_LOG``-gated structured lines),
:mod:`.skew` (measured-vs-simulated comparisons).
"""
from .flight import (FlightRecorder, dump_postmortem, get_flight,
                     postmortem_dir, set_postmortem_dir)
from .log import log
from .metrics import Metrics, get_metrics, set_metrics
from .skew import diff_traces, stage_skew
from .trace import (CONTROL_TRACK, NULL_SPAN, PLANNER_TRACK, STAGE_CAT,
                    Tracer, device_track, get_tracer, link_track,
                    load_trace, set_tracer, span, span_events,
                    write_trace)

__all__ = [
    "CONTROL_TRACK", "NULL_SPAN", "PLANNER_TRACK", "STAGE_CAT",
    "FlightRecorder", "Metrics", "Tracer",
    "device_track", "diff_traces", "dump_postmortem", "get_flight",
    "get_metrics", "get_tracer", "link_track", "load_trace", "log",
    "postmortem_dir", "set_metrics", "set_postmortem_dir", "set_tracer",
    "span", "span_events", "stage_skew", "write_trace",
]
