"""One run of one cell: set-up, the measured window, the comparison that
decides ``correct``, and the metrics.

Everything a cell is made of is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (``bench/configs/<config>.json``)
and its traffic mix (``bench/traffic/<traffic>.json``); the cell's own
file ``bench/workloads/<cell>.json`` holds what the comparison and the
traced slice need (``check``, ``limits``, ``trace``); the configuration
names its driver (``bench/drivers/<driver>.py``); each metric the cell
reports is read by ``bench/metrics/<metric>.py``; the configuration
names its plain reference (``bench/reference/<reference>.py``).  A cell,
a mix, a configuration or a metric is added by adding files and entries.

A driver module has a ``Driver(config, mix, check, seed, device)``
(``check``: the cell file's) whose construction is the entry point's
set-up (weights made on the device from the seed, the program built),
with:

* ``warm_up()``: every shape the cell's traffic uses, once;
* ``serve(request, tracer) -> Served``: one request through the entry
  point, calling ``tracer.step(request, i)`` as each decode step ``i``
  starts when a tracer is given;
* ``keep(kept)``: what of a served request's outputs (``Served.kept``)
  the comparison reads, called for each request the window's sample
  takes as it finishes (:class:`Keep`);
* ``release()``: drops the program's state once the window has closed;
* ``samples(served) -> [compare.Sample]``: the sequences the comparison
  reads from the sampled requests;
* ``reference(tokens, positions, rounding=None)``: the plain reference's
  f32 logits (``rounding``: the control's lower precision);
* ``window_flops(served)``: the model's operations for what was served;
* ``decode_calls(request, step)``: the paged decode calls of one step, as
  ``(rows, kv_rows, kv_len, head_dim, element_bytes)``.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from bench import compare, traffic
from bench.profile import Slice, Trace, busy_seconds, idle_by_host

ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Served:
    """One request as the window served it.  ``tokens``: sequence
    positions the model's step processed (batch x steps); ``token_walls_ms``:
    the wall of each generated token that the host read back, where the
    entry point returns tokens one at a time; ``kept``: the outputs the
    comparison may read, ``None`` once the sample has left the request
    out; ``ok``: the outputs have the shape and count they must."""
    request: traffic.Request
    t_start: float
    t_end: float
    tokens: int
    token_walls_ms: List[float]
    kept: Any
    ok: bool = True


@dataclasses.dataclass
class Cell:
    name: str
    entry: Dict          # the cell's entry in BENCHMARK.json
    config: Dict
    mix: Dict
    spec: Dict           # bench/workloads/<cell>.json
    metrics: Dict[str, List[Dict]]   # "end_to_end", "per_layer" entries


def load_json(path: Path) -> Dict:
    return json.loads(path.read_text())


def reported(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    manifest = load_json(root / "BENCHMARK.json")
    entries = [w for w in manifest["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    entry = entries[0]
    bench = root / "bench"
    return Cell(name, entry,
                load_json(bench / "configs" / f"{entry['config']}.json"),
                traffic.load(entry["traffic"], bench / "traffic"),
                load_json(bench / "workloads" / f"{name}.json"),
                {kind: [m for m in manifest[kind] if reported(m, name)]
                 for kind in ("end_to_end", "per_layer")})


class Tracer:
    """Profiles the last ``last_steps`` decode steps of request number
    ``request``, with the device synchronised at both ends."""

    def __init__(self, request: int, last_steps: int):
        self.request, self.last_steps = request, last_steps
        self.slice = Slice()
        self.steps: List[Tuple[traffic.Request, int]] = []

    def step(self, req: traffic.Request, i: int) -> None:
        if req.index != self.request:
            return
        if i == max(0, req.steps - self.last_steps):
            self.slice.start()
        if self.slice.active:
            self.steps.append((req, i))

    def done(self, req: traffic.Request) -> None:
        if req.index == self.request and self.slice.active:
            self.slice.stop()

    @property
    def trace(self) -> Optional[Trace]:
        return self.slice.trace


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    cell: Cell
    driver: Any
    setup_s: float
    window_s: float
    served: List[Served]
    tracer: Optional[Tracer]

    @property
    def trace(self) -> Optional[Trace]:
        return self.tracer.trace if self.tracer is not None else None


def driver_of(config: Dict):
    return importlib.import_module(f"bench.drivers.{config['driver']}")


def reference_of(config: Dict):
    """The configuration's plain reference: ``bench/reference/<name>.py``
    by the file's ``reference``."""
    return importlib.import_module(f"bench.reference.{config['reference']}")


def read_metrics(run: Run, kind: str) -> Dict[str, Dict]:
    out = {}
    for m in run.cell.metrics[kind]:
        value = importlib.import_module(f"bench.metrics.{m['name']}").read(
            run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(trace: Trace, top: int = 10) -> Dict[str, List]:
    """The device operations that took the most time, and the idle time
    by what the host was doing, each at most ``top`` entries."""
    ops: Dict[str, float] = {}
    for name, a, b, _ in trace.device:
        ops[name] = ops.get(name, 0.0) + (b - a)

    def head(d):
        return [[k[:160], v] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])[:top]]
    return {"device_ops": head(ops), "idle_gaps": head(idle_by_host(trace))}


class Keep:
    """The served requests the comparison reads: ``k`` drawn uniformly by
    ``rng`` from all the window finishes, as they finish (reservoir
    sampling), and the first of the longest.  The outputs of the others
    are dropped as soon as the sample leaves them out, so what a run holds
    does not grow with the requests it serves."""

    def __init__(self, k: int, rng):
        self.k, self.rng = k, rng
        self.sample: List[int] = []
        self.longest: Optional[int] = None

    def offer(self, served: List[Served]) -> bool:
        """Whether the sample takes the newest of ``served``; the
        outputs of any request it leaves out are dropped."""
        i = len(served) - 1
        out = []
        if i < self.k:
            self.sample.append(i)
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.k:
                out.append(self.sample[j])
                self.sample[j] = i
            else:
                out.append(i)
        if self.longest is None or (served[i].request.steps
                                    > served[self.longest].request.steps):
            out.append(self.longest)
            self.longest = i
        taken = set(self.sample) | {self.longest}
        for d in out:
            if d is not None and d not in taken:
                served[d].kept = None
        return i in taken


def window(drv, mix: Dict, seed: int, seconds: float, keep: int,
           tracer: Optional[Tracer] = None,
           requests: Optional[int] = None) -> Tuple[List[Served], float]:
    """The measured window: the mix's requests one after another while
    ``seconds`` have not passed since the first started (or the first
    ``requests`` of them); the served requests, of which the ``keep``
    that :class:`Keep` samples from the seed (and the longest) keep their
    outputs, and the seconds from the first one's start to the last one's
    end."""
    served: List[Served] = []
    sent = traffic.requests(mix, seed)
    sample = Keep(keep, np.random.default_rng(traffic.seed_of(seed, 2)))
    t0 = time.perf_counter()
    while (len(served) < requests if requests is not None
           else time.perf_counter() - t0 < seconds):
        served.append(drv.serve(next(sent), tracer))
        if sample.offer(served):
            served[-1].kept = drv.keep(served[-1].kept)
    return served, served[-1].t_end - t0


def sampled(served: List[Served]) -> List[Served]:
    return [s for s in served if s.kept is not None]


def _note(what: str, text: str) -> None:
    """A line for the reader of a run's standard error."""
    print(f"bench: {what}: {text}", file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, requests: Optional[int] = None) -> Dict:
    """Set-up, window, comparison and metrics of one run; the result's
    keys but ``device``'s name and the isolation check, which the caller
    adds.  ``requests`` makes the window the first that many requests
    (the tests' fixed windows)."""
    import torch
    device = torch.device(device)
    stamps = [("import", time.perf_counter())]
    drv = driver_of(cell.config).Driver(cell.config, cell.mix,
                                        cell.spec["check"], seed, device)
    stamps.append(("program and weights", time.perf_counter()))
    drv.warm_up()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stamps.append(("warm-up", time.perf_counter()))
    setup_s = stamps[-1][1] - t_start
    tracer = Tracer(**cell.spec["trace"]) if trace else None

    served, window_s = window(drv, cell.mix, seed, seconds,
                              cell.spec["check"]["requests"], tracer,
                              requests)
    _note("set-up", " ".join(
        f"{name} {b - a:.3f} s" for (name, b), (_, a)
        in zip(stamps, [("", t_start)] + stamps[:-1])))
    _note("window", f"{len(served)} requests {sum(s.tokens for s in served)}"
          f" tokens {window_s:.3f} s")

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    run = Run(cell, drv, setup_s, window_s, served, tracer)
    metrics = read_metrics(run, "per_layer" if trace else "end_to_end")
    drv.release()

    samples = drv.samples(sampled(served))
    numbers = compare.program_numbers(samples, drv.reference)
    compared = compare.judge(numbers, cell.spec["limits"])
    failed = sum(not s.ok for s in served)
    result = {
        "correct": failed == 0 and all(c["ok"] for c in compared),
        "attempted": len(served), "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if trace:
        t = run.trace
        if t is not None:
            result["device"]["busy_s"] = busy_seconds(t.device)
            result["device"]["window_s"] = t.wall_s
            result["breakdown"] = breakdown(t)
    result["compared"] = {c["name"]: {"value": c["value"],
                                      "limit": c["limit"]}
                          for c in compared}
    return result
