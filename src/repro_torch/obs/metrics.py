"""Labeled counters / gauges / histograms with JSON snapshots.

A :class:`Metrics` registry keys every instrument by ``(name, sorted
label items)`` and renders keys Prometheus-style
(``name{k="v",k2="v2"}``) in :meth:`Metrics.snapshot`.  Histograms use
power-of-two buckets (``le_2^k``) plus count/sum/min/max — enough to
read convergence and cache-hit behaviour without a stats dependency.

Like tracing (``obs.trace``), collection is opt-in: the module-level
registry is ``None`` by default and the free functions (:func:`inc`,
:func:`gauge`, :func:`observe`) are no-ops until :func:`set_metrics`
installs one.  Hot paths may also accumulate plain ints locally and
push one batched :func:`inc` at the end of a phase.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Any, Dict, Optional, Tuple

_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Dict[str, Any]) -> _Key:
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


def _render(key: _Key) -> str:
    name, items = key
    if not items:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in items)
    return f"{name}{{{inner}}}"


class Metrics:
    """Thread-safe registry of labeled counters, gauges, histograms."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[_Key, float] = {}
        self._gauges: Dict[_Key, float] = {}
        self._hists: Dict[_Key, Dict[str, Any]] = {}

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        k = _key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + value

    def gauge(self, name: str, value: float, **labels) -> None:
        k = _key(name, labels)
        with self._lock:
            self._gauges[k] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        k = _key(name, labels)
        v = float(value)
        with self._lock:
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = {"count": 0, "sum": 0.0,
                                      "min": math.inf, "max": -math.inf,
                                      "buckets": {}}
            h["count"] += 1
            h["sum"] += v
            h["min"] = min(h["min"], v)
            h["max"] = max(h["max"], v)
            # power-of-two bucket: smallest k with v <= 2^k
            exp = 0 if v <= 0 else math.ceil(math.log2(v)) if v > 0 else 0
            b = f"le_2^{exp}"
            h["buckets"][b] = h["buckets"].get(b, 0) + 1

    def counter_value(self, name: str, **labels) -> float:
        with self._lock:
            return self._counters.get(_key(name, labels), 0.0)

    def gauge_value(self, name: str, **labels) -> Optional[float]:
        with self._lock:
            return self._gauges.get(_key(name, labels))

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready snapshot: ``{"counters": {...}, "gauges": {...},
        "histograms": {...}}`` with Prometheus-style keys."""
        with self._lock:
            counters = {_render(k): v for k, v in self._counters.items()}
            gauges = {_render(k): v for k, v in self._gauges.items()}
            hists = {}
            for k, h in self._hists.items():
                out = dict(h)
                out["buckets"] = dict(h["buckets"])
                if out["count"] == 0:
                    out["min"] = out["max"] = None
                hists[_render(k)] = out
        return {"counters": counters, "gauges": gauges,
                "histograms": hists}

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)
        return path


# ---------------------------------------------------------------------------
# global registry (None by default — collection is opt-in)
# ---------------------------------------------------------------------------

_METRICS: Optional[Metrics] = None


def get_metrics() -> Optional[Metrics]:
    return _METRICS


def set_metrics(m: Optional[Metrics]) -> Optional[Metrics]:
    global _METRICS
    _METRICS = m
    return m


def inc(name: str, value: float = 1.0, **labels) -> None:
    m = _METRICS
    if m is not None:
        m.inc(name, value, **labels)


def gauge(name: str, value: float, **labels) -> None:
    m = _METRICS
    if m is not None:
        m.gauge(name, value, **labels)


def observe(name: str, value: float, **labels) -> None:
    m = _METRICS
    if m is not None:
        m.observe(name, value, **labels)
