"""Flight recorder: a bounded ring of recent events + postmortem dumps.

The recorder is always on (one deque append per recorded event — it
never touches numerics, so instrumented and uninstrumented runs stay
bit-identical) and bounded (``capacity`` events, oldest evicted), so
it can ride along every mesh dispatch, replan, and refine iteration at
negligible cost.  When a failure fires (``StageFailure`` / stage
watchdog timeout / ``RefineOscillationError``), :func:`dump_postmortem`
writes a JSON artifact with the failure context, the recent ring, and
— when a tracer is installed — the tail of its recorded spans, to the
directory configured by :func:`set_postmortem_dir` or the
``REPRO_POSTMORTEM_DIR`` environment variable.  With no directory
configured the dump is a no-op returning ``None`` (the default:
failures raise exactly as before, just without the artifact).
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from . import trace as _trace

#: environment variable naming the postmortem output directory
POSTMORTEM_ENV = "REPRO_POSTMORTEM_DIR"

#: how many trailing tracer spans a postmortem captures
SPAN_TAIL = 64


class FlightRecorder:
    """Bounded ring buffer of ``{"t_us", "kind", ...fields}`` events."""

    def __init__(self, capacity: int = 512) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        self._epoch = time.perf_counter()
        self._total = 0

    def record(self, kind: str, **fields) -> None:
        ev = {"t_us": (time.perf_counter() - self._epoch) * 1e6,
              "kind": kind}
        ev.update(fields)
        with self._lock:
            self._buf.append(ev)
            self._total += 1

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    @property
    def total_recorded(self) -> int:
        """Events recorded over the recorder's lifetime (>= ``len``
        once the ring has wrapped)."""
        with self._lock:
            return self._total

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)


_FLIGHT = FlightRecorder()
_DIR: Optional[str] = None
_SEQ = itertools.count()


def get_flight() -> FlightRecorder:
    """The process-wide flight recorder (always available)."""
    return _FLIGHT


def set_postmortem_dir(path: Optional[str]) -> None:
    """Configure where :func:`dump_postmortem` writes (overrides the
    ``REPRO_POSTMORTEM_DIR`` environment variable; ``None`` defers back
    to it)."""
    global _DIR
    _DIR = path


def postmortem_dir() -> Optional[str]:
    return _DIR if _DIR is not None else \
        (os.environ.get(POSTMORTEM_ENV) or None)


def dump_postmortem(reason: str,
                    context: Optional[Dict[str, Any]] = None,
                    directory: Optional[str] = None) -> Optional[str]:
    """Write a postmortem artifact and return its path — or ``None``
    when no output directory is configured.

    The artifact carries ``reason``, the caller's ``context`` (for a
    stage failure: the failing stage's kind/label/timeout — its span
    context), the flight ring, and the last :data:`SPAN_TAIL` spans of
    the installed tracer, if any."""
    d = directory if directory is not None else postmortem_dir()
    if d is None:
        return None
    os.makedirs(d, exist_ok=True)
    tracer = _trace.get_tracer()
    spans: List[Dict[str, Any]] = []
    if tracer is not None:
        spans = tracer.spans()[-SPAN_TAIL:]
    doc = {
        "reason": reason,
        "context": dict(context) if context else {},
        "events": _FLIGHT.events(),
        "spans": spans,
    }
    path = os.path.join(
        d, f"postmortem-{os.getpid()}-{next(_SEQ)}-{reason}.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True, default=str)
    return path
