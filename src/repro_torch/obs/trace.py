"""Thread-safe span tracer with Chrome/Perfetto trace-event export.

Zero-dependency observability spine: a :class:`Tracer` records
**complete spans** (``ph: "X"``) and **instant events** (``ph: "i"``)
on named *tracks* (one Perfetto thread row per track — by convention
one per planned device, ``dev0..devN-1``, plus :data:`PLANNER_TRACK`
and :data:`CONTROL_TRACK`), timestamped in microseconds on the
monotonic clock relative to the tracer's epoch.

Tracing is **off by default** and strictly zero-overhead when off:
:func:`span` returns the module-level :data:`NULL_SPAN` singleton (no
per-call allocation, no recording), and hot paths that cannot afford
even that call cache :func:`get_tracer` once and skip instrumentation
entirely when it is ``None``.  Install a tracer with
:func:`set_tracer`; every recorded span carries ``(track, name, cat,
t0_us, dur_us, depth, args)`` and exports to the Chrome trace-event
JSON schema (``ph``/``ts``/``pid``/``tid``/``name`` — load the file at
https://ui.perfetto.dev).  The same schema is used for the *simulated*
timeline (``cluster.simsched.export_sim_trace``), so a measured mesh
trace and its prediction diff structurally (``obs.skew``).
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

#: canonical track names (Perfetto thread rows)
PLANNER_TRACK = "planner"
CONTROL_TRACK = "control"

#: span categories with gate semantics: ``cat="stage"`` spans on the
#: control track are the ones contracted to match
#: ``ExecStats.stage_times`` 1:1
STAGE_CAT = "stage"


def device_track(i: int) -> str:
    """Track name for planned device ``i``."""
    return f"dev{i}"


def link_track(i: int) -> str:
    """Track name for cluster link ``i`` (simulated timelines)."""
    return f"link{i}"


class _NullSpan:
    """Inert span: the disabled-tracing fast path.  A single module
    level instance is returned by :func:`span` for every call, so the
    no-op path allocates nothing per call."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args) -> None:
        pass

    def event(self, name: str, **args) -> None:
        pass


NULL_SPAN = _NullSpan()


class Span:
    """One open span; use as a context manager.  ``set(**args)`` attaches
    arguments; ``event(name)`` drops an instant event on the span's
    track while it is open."""

    __slots__ = ("_tracer", "track", "name", "cat", "args",
                 "_t0", "depth")

    def __init__(self, tracer: "Tracer", track: str, name: str,
                 cat: str, args: Dict[str, Any]) -> None:
        self._tracer = tracer
        self.track = track
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0.0
        self.depth = 0

    def __enter__(self) -> "Span":
        self.depth = self._tracer._enter(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        self._tracer._exit(self, self._t0, t1, failed=exc[0] is not None)
        return False

    def set(self, **args) -> None:
        self.args.update(args)

    def event(self, name: str, **args) -> None:
        self._tracer.instant(self.track, name, **args)


class Tracer:
    """Collects span/instant records; thread safe; exports Perfetto
    trace-event JSON via :meth:`to_perfetto` / :func:`write_trace`.

    ``pid``/``process`` name the Perfetto process row — measured traces
    use ``(1, "measured")``, simulated timelines ``(2, "simulated")``,
    so both fit in one file and line up vertically.
    """

    def __init__(self, process: str = "measured", pid: int = 1) -> None:
        self.process = process
        self.pid = pid
        self._epoch = time.perf_counter()
        self._lock = threading.Lock()
        self._records: List[Dict[str, Any]] = []
        self._tracks: Dict[str, int] = {}
        self._tls = threading.local()

    # -- clock -------------------------------------------------------------

    def now_us(self) -> float:
        """Microseconds since this tracer's epoch (monotonic)."""
        return (time.perf_counter() - self._epoch) * 1e6

    # -- recording ---------------------------------------------------------

    def ensure_track(self, track: str) -> int:
        """tid of ``track``, assigning the next id on first use."""
        with self._lock:
            tid = self._tracks.get(track)
            if tid is None:
                tid = len(self._tracks) + 1
                self._tracks[track] = tid
            return tid

    def span(self, track: str, name: str, cat: str = "span",
             **args) -> Span:
        return Span(self, track, name, cat, args)

    def instant(self, track: str, name: str, cat: str = "event",
                **args) -> None:
        self.ensure_track(track)
        rec = {"ph": "i", "track": track, "name": name, "cat": cat,
               "ts": self.now_us(), "args": args}
        with self._lock:
            self._records.append(rec)

    def add_complete(self, track: str, name: str, t0_us: float,
                     dur_us: float, cat: str = "span", depth: int = 0,
                     args: Optional[Dict[str, Any]] = None) -> None:
        """Record an externally-timed complete span (e.g. a mesh stage
        whose wall time was measured by the executor itself)."""
        self.ensure_track(track)
        rec = {"ph": "X", "track": track, "name": name, "cat": cat,
               "ts": float(t0_us), "dur": float(dur_us), "depth": depth,
               "args": dict(args) if args else {}}
        with self._lock:
            self._records.append(rec)

    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _enter(self, sp: Span) -> int:
        self.ensure_track(sp.track)
        st = self._stack()
        depth = len(st)
        st.append(sp)
        return depth

    def _exit(self, sp: Span, t0: float, t1: float,
              failed: bool = False) -> None:
        st = self._stack()
        if st and st[-1] is sp:
            st.pop()
        if failed:
            sp.args.setdefault("error", True)
        rec = {"ph": "X", "track": sp.track, "name": sp.name,
               "cat": sp.cat, "ts": (t0 - self._epoch) * 1e6,
               "dur": (t1 - t0) * 1e6, "depth": sp.depth,
               "args": sp.args}
        with self._lock:
            self._records.append(rec)

    # -- introspection -----------------------------------------------------

    def spans(self, cat: Optional[str] = None,
              track: Optional[str] = None) -> List[Dict[str, Any]]:
        """Recorded complete spans (``ph == "X"``), in start order,
        optionally filtered by category and/or track."""
        with self._lock:
            recs = list(self._records)
        out = [r for r in recs if r["ph"] == "X"
               and (cat is None or r["cat"] == cat)
               and (track is None or r["track"] == track)]
        out.sort(key=lambda r: r["ts"])
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    # -- export ------------------------------------------------------------

    def to_perfetto(self) -> Dict[str, Any]:
        """Chrome trace-event JSON object (``{"traceEvents": [...]}``)
        with process/thread-name metadata for every track."""
        with self._lock:
            recs = list(self._records)
            tracks = dict(self._tracks)
        events: List[Dict[str, Any]] = [{
            "ph": "M", "pid": self.pid, "tid": 0,
            "name": "process_name", "args": {"name": self.process}}]
        for track, tid in sorted(tracks.items(), key=lambda kv: kv[1]):
            events.append({"ph": "M", "pid": self.pid, "tid": tid,
                           "name": "thread_name",
                           "args": {"name": track}})
        for r in sorted(recs, key=lambda r: r["ts"]):
            ev: Dict[str, Any] = {
                "ph": r["ph"], "ts": r["ts"], "pid": self.pid,
                "tid": tracks[r["track"]], "name": r["name"],
                "cat": r["cat"]}
            if r["ph"] == "X":
                ev["dur"] = r["dur"]
            elif r["ph"] == "i":
                ev["s"] = "t"
            if r.get("args"):
                ev["args"] = r["args"]
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_trace(path: str, *tracers: Tracer) -> str:
    """Merge one or more tracers into a single Perfetto trace file
    (distinct ``pid`` per tracer keeps their tracks separate rows)."""
    events: List[Dict[str, Any]] = []
    for t in tracers:
        events.extend(t.to_perfetto()["traceEvents"])
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f,
                  indent=1, sort_keys=True)
    return path


def load_trace(path: str) -> Dict[str, Any]:
    """Load a trace file written by :func:`write_trace`."""
    with open(path) as f:
        return json.load(f)


def span_events(trace: Dict[str, Any], cat: Optional[str] = None,
                pid: Optional[int] = None,
                track: Optional[str] = None) -> List[Dict[str, Any]]:
    """Complete-span events of a loaded trace in timestamp order,
    with their track names resolved from the thread-name metadata."""
    names: Dict[Tuple[int, int], str] = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            names[(ev["pid"], ev["tid"])] = ev["args"]["name"]
    out = []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        if pid is not None and ev.get("pid") != pid:
            continue
        if cat is not None and ev.get("cat") != cat:
            continue
        ev = dict(ev)
        ev["track"] = names.get((ev.get("pid"), ev.get("tid")),
                                str(ev.get("tid")))
        if track is not None and ev["track"] != track:
            continue
        out.append(ev)
    out.sort(key=lambda e: e["ts"])
    return out


# ---------------------------------------------------------------------------
# global tracer (None by default — tracing is opt-in)
# ---------------------------------------------------------------------------

_TRACER: Optional[Tracer] = None


def get_tracer() -> Optional[Tracer]:
    """The installed tracer, or ``None`` (the default: tracing off).
    Hot paths cache this once per run and skip instrumentation when it
    is ``None`` — that is the strictly-zero-overhead contract."""
    return _TRACER


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install (or, with ``None``, remove) the process-wide tracer."""
    global _TRACER
    _TRACER = tracer
    return tracer


def span(track: str, name: str, cat: str = "span", **args):
    """Open a span on the installed tracer — or return the shared
    :data:`NULL_SPAN` (no allocation, nothing recorded) when tracing is
    off."""
    t = _TRACER
    if t is None:
        return NULL_SPAN
    return t.span(track, name, cat, **args)


def instant(track: str, name: str, **args) -> None:
    """Drop an instant event on the installed tracer, if any."""
    t = _TRACER
    if t is not None:
        t.instant(track, name, **args)
