"""Reading the device from ``torch.profiler``: a bounded slice of a run,
its kernels and the host's operations, and the busy time of the device.

The busy arithmetic is ``chip_smoke.py::device_profile``'s, frozen here so
that the yardstick stays fixed when the program changes: busy time is the
union of the intervals in which an operation ran on the device, so kernels
that overlap on concurrent streams (the mesh's node streams) count once;
the summed kernel time counts them each.

A slice starts and stops with the device synchronised, so the operations
the profiler records are exactly those the host issued inside it.  It is
profiled with CPU and CUDA activity and nothing else (no shapes, no
stacks), and read from the profiler's raw events: a whole measured window
would be millions of kernel events, so a slice is a bounded number of
steps, which the cell's file sets.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

#: (name, start s, end s, stream) on the profiler's clock
Span = Tuple[str, float, float, int]


@dataclasses.dataclass
class Trace:
    """What a slice recorded.  ``device``: every operation that ran on the
    device (kernels, copies, sets); ``host``: the host's operations and
    runtime calls; ``wall_s``: the slice's length on the host clock, from
    the synchronised start to the synchronised stop."""
    device: List[Span]
    host: List[Span]
    wall_s: float


def busy_seconds(spans) -> float:
    """The union of the spans' intervals, in seconds."""
    busy, end = 0.0, float("-inf")
    for _, a, b, *_ in sorted(spans, key=lambda s: s[1]):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def summed_seconds(spans) -> float:
    return sum(b - a for _, a, b, *_ in spans)


def idle_gaps(device: List[Span]) -> List[Tuple[float, float]]:
    """The intervals between the device's busy stretches, in order."""
    gaps, end = [], None
    for _, a, b, *_ in sorted(device, key=lambda s: s[1]):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    return gaps


def idle_by_host(trace: Trace) -> Dict[str, float]:
    """Idle seconds of the device by what the host was doing: each gap
    goes to the innermost host operation running at its middle (the
    latest-starting one that still runs then; nested operations of one
    thread start in order)."""
    host = sorted(trace.host, key=lambda s: s[1])
    starts = [s[1] for s in host]
    out: Dict[str, float] = {}
    for a, b in idle_gaps(trace.device):
        t = (a + b) / 2
        label = "(no host operation)"
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(-1, i - 64), -1):
            if host[j][2] >= t:
                label = host[j][0]
                break
        out[label] = out.get(label, 0.0) + (b - a)
    return out


class Slice:
    """``start()`` and ``stop()`` a profiled slice on the card; ``trace``
    is what it recorded once stopped."""

    def __init__(self):
        self.trace: Optional[Trace] = None
        self._prof = None
        self._t0 = 0.0

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        prof, self._prof = self._prof, None
        prof.stop()
        device, host = [], []
        for e in prof.profiler.kineto_results.events():
            span = (e.name(), e.start_ns() * 1e-9,
                    (e.start_ns() + e.duration_ns()) * 1e-9,
                    int(e.device_resource_id()))
            if str(e.device_type()).endswith("CUDA"):
                device.append(span)
            else:
                host.append(span)
        self.trace = Trace(device, host, wall)
