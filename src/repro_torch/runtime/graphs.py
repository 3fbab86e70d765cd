"""Captured CUDA graphs: the port's counterpart of the reference's
``jax.jit`` programs (the segment programs of ``Session.run``, the mesh
executor's stage programs and the decode step).

A :class:`GraphProgram` runs ``fn(*inputs)`` on fixed input tensors on the
card:

* the first call runs ``fn`` eagerly.  This is the warm-up: it builds and
  loads the kernels, and each kernel instance makes its once-only
  attribute calls (``cudaFuncSetAttribute``) there, outside any capture;
* the second call captures ``fn`` as one ``torch.cuda.CUDAGraph`` on a
  side stream, then replays it;
* every later call replays it.

``fn`` returns a tensor or a list or tuple of them (a mesh stage returns
each node's outputs).  It may fork work onto other streams of the device
(each waits on the stream ``fn`` was called on) as long as it joins them
again before it returns: the capture then records every stream's work
into the one graph, in the graph's own memory pool, and the replay runs
the branches as the graph's parallel paths.

The program owns its input tensors: a call copies each argument into its
input (an argument that is the input itself is left as it is), and the
graph reads them where they lie.  The caller reads the outputs before the
next call, which overwrites them in the graph's memory.

Memory: every graph captures into a private memory pool of its own, so
graphs replay in any order (cache hits across sessions, programs dropped
and captured again) and a dropped graph frees its memory.  A dropped
program caught in a reference cycle (a stage program's body holds the
program) frees its graph only when Python's cyclic collector runs, and a
graph freed while another capture is under way invalidates that capture
(``cudaGraphExecDestroy`` is not permitted then).  So the collector is
paused for the length of each capture and frees such graphs between
captures.

Launch counters: the ``launches`` counter of each kernel wrapper
(:data:`COUNTED`), and the per-route ``routes`` counts of the two shard
kernels and the paged decode kernel, count kernels that ran on the device.  A capture runs nothing,
so what the wrappers add while one is under way is taken back and kept
as the program's counts, which every replay adds.

Faults propagate.  An operation that a capture does not permit (a host
sync such as ``.item()``) fails the capture and raises; nothing falls
back to the eager path.  The device's default generator is left with the
state it had before the failed capture, so the process draws from it as
before.
"""
from __future__ import annotations

import gc
from typing import Any, Callable, Dict

import torch

from repro_torch.kernels.conv2d import conv2d_shard
from repro_torch.kernels.flash_attention import (flash_attention_bh,
                                                 flash_decode_paged)
from repro_torch.kernels.ops import matmul_tiled

__all__ = ["COUNTED", "GraphProgram"]

#: the kernel wrappers whose ``launches`` a capture takes back and a
#: replay adds
COUNTED = (conv2d_shard, matmul_tiled, flash_decode_paged,
           flash_attention_bh)

_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """One side stream per device for every capture (a capture cannot
    run on the default stream)."""
    stream = _STREAMS.get(device)
    if stream is None:
        stream = _STREAMS[device] = torch.cuda.Stream(device)
    return stream


class GraphProgram:
    """``fn(*inputs)`` on the card: eager on the first call, captured as a
    CUDA graph on the second and replayed on that and every later call.
    ``inputs`` are the program's own CUDA tensors; each call's arguments
    are copied into them.  A call returns what ``fn`` returned (on a
    replay, the tensors the capture left in the graph's memory)."""

    def __init__(self, fn: Callable[..., Any],
                 *inputs: torch.Tensor):
        self.device = inputs[0].device
        if self.device.type != "cuda":
            raise ValueError(f"a GraphProgram runs on the card, its inputs "
                             f"lie on {self.device}")
        self.fn = fn
        self.inputs = inputs
        self.calls = 0
        self.graph = None
        self.out = None
        self.launches = ()
        self.routes = ()

    def __call__(self, *args: torch.Tensor) -> Any:
        for dst, src in zip(self.inputs, args):
            if src is not dst:
                dst.copy_(src)
        self.calls += 1
        if self.graph is None:
            if self.calls == 1:
                return self.fn(*self.inputs)
            self._capture()
        self.graph.replay()
        for wrapper, n in self.launches:
            wrapper.launches += n
        for wrapper, by in self.routes:
            for route, n in by.items():
                wrapper.routes[route] += n
        return self.out

    def _record(self) -> None:
        before = [f.launches for f in COUNTED]
        routed = [(f, dict(f.routes)) for f in COUNTED if hasattr(f, "routes")]
        graph = torch.cuda.CUDAGraph()
        stream = _capture_stream(self.device)
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        collecting = gc.isenabled()
        gc.disable()      # no dropped graph is freed inside the capture
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin()
                try:
                    out = self.fn(*self.inputs)
                finally:
                    graph.capture_end()
            self.launches = tuple((f, f.launches - n)
                                  for f, n in zip(COUNTED, before)
                                  if f.launches != n)
            self.routes = tuple(
                (f, {r: f.routes[r] - n for r, n in by.items()
                     if f.routes[r] != n})
                for f, by in routed if f.routes != by)
        finally:
            if collecting:
                gc.enable()
            for f, n in zip(COUNTED, before):
                f.launches = n
            for f, by in routed:
                f.routes.update(by)
        current.wait_stream(stream)
        self.graph, self.out = graph, out

    def _capture(self) -> None:
        """:meth:`_record` with the device's default generator restored if
        the capture fails: a capture registers the generator with its
        graph, and a failed one ends without taking it back, after which
        every draw on the device raises.  The generator gets back the
        state it had before the capture (draws inside a capture do not
        advance it)."""
        rng = torch.cuda.default_generators[self.device.index]
        before = rng.clone_state()
        try:
            self._record()
        except BaseException:
            rng.graphsafe_set_state(before)
            raise
