"""Mesh executor of the port: run a FlexPie plan with every planned node's
shard programs running concurrently, each node a CUDA stream of the card.

The port of ``repro/runtime/mesh_exec.py``.  The reference places each
node on its own JAX device and runs every pipeline stage as one
``jit(shard_map(...))`` program over the ``nodes`` axis, one process
driving all devices.  The port keeps that single controller on one card
(:func:`repro_torch.launch.mesh.make_nodes_mesh`, the one-card mapping):

* **A stage is one program over all nodes.**  It forks (every node stream
  waits on the stream the stage was called on), runs each node's branch
  on that node's stream — the reference's ``lax.switch`` over
  ``axis_index`` — and joins (the calling stream waits on every node
  stream).  On the card a stage program is a
  :class:`~repro_torch.runtime.graphs.GraphProgram`: eager on its first
  call, captured as one CUDA graph over the node streams on its second,
  replayed after.  On the CPU the branches run one after another.
* **Neighbor halo exchange** (the reference's ``ppermute``): at a T
  boundary between two segments of the same InH/InW scheme, node ``i``'s
  bottom ``h_up`` rows become node ``i+1``'s up halo and node ``i+1``'s top
  ``h_dn`` rows node ``i``'s down halo, each a copy onto the receiver's
  stream after an event on the sender's.  The receiver splices them onto
  its own rows to assemble the halo-extended slice its segment records
  consume — the local executor's ``_segment_records``, and therefore the
  same shard kernels.  Node 0's up halo and the last node's down halo are
  zero blocks, as ``ppermute`` leaves them; nothing reads them.
* **Gather re-layout** (the reference's ``all_gather`` and rebuild):
  scheme changes, OutC/2D-grid layouts, fork deliveries, ADD/CONCAT
  merges and the final gather copy each node's cells, on the node's
  stream, into the replicated tensor, which the one-card mapping holds
  once.

State between stages holds each node's own tensors (no zero-padded
``[N, ...]`` stacks: those exist in the reference only because
``shard_map`` needs uniform shapes).  No port is owed of that padding nor
of ``_MeshRun.serialize``, which orders the reference's stage programs
on the CPU host platform, whose fake devices share one thread pool and
rendezvous inside ``shard_map``: both are JAX mechanism, and the port has
neither the uniform-shape rule nor the shared pool.

**Overlapped boundaries** (``overlap=True``, the default): a segment whose
exit boundary is permute-compatible computes its border strips first —
the rows its neighbors need — records its event, and only then enqueues
its interior, so that inside the stage's graph the halo copies run under
the interior compute.  With ``overlap=False`` every exchange is its own
sync stage, one to one with the reference simulator's stage DAG
(:func:`validate_stage_decomposition`).

A stage's outputs lie in its graph's memory, and its next replay
overwrites them: the consuming stage copies them into its own inputs
(``GraphProgram`` does so for its arguments), every program is keyed by
its occurrence in the run as well as by its signature, so no program runs
twice in one run, and the final output is copied out.

Stats contract: the geometry accounting (``sync_points`` /
``bytes_received`` / ``redundant_elems`` / ``compute_stages``) comes from
the local executor's backward-chained rects and equals it; measured
``stage_times`` / ``wall_s`` and the fault counters are excluded from
``ExecStats`` equality.

``instrument=True`` times each stage: its wall on the host clock, and each
node's completion from timing events that the stage program records on
the node streams.  They are external events, so the captured graph keeps
them and every replay times itself.  With a tracer installed
(``repro_torch.obs.set_tracer``) each timed stage also becomes one
control-track ``cat="stage"`` span, one to one with
``ExecStats.stage_times``, and each node's completion a ``cat="device"``
span on its track; the flight ring records every dispatch, retry and
failure, and a terminal failure dumps a postmortem.  All of it happens on
the host around the stage program, never inside a capture, so a replayed
program records its spans on every run.

A 1-node plan degenerates to plain programs on the device: no streams are
forked and nothing is copied between nodes.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.graph import LayerSpec, ModelGraph
from repro_torch.core.partition import DTYPE_BYTES, Scheme
from repro_torch.core.plan import Plan, steps_segments
from repro_torch.launch.mesh import NodesMesh, check_mesh, make_nodes_mesh
from repro_torch.obs import flight as _obs_flight
from repro_torch.obs import trace as _obs_trace
from repro_torch.runtime.engine import (BACKENDS, ExecStats, Rect,
                                        SegmentCacheInfo, StageTime,
                                        _merge_comm_bytes, _rect_elems,
                                        _rect_isect, _run_partitioned_local,
                                        _run_records, _segment_records,
                                        _weight_key, backward_chain,
                                        exact_regions, merge_tensors)
from repro_torch.runtime.graphs import GraphProgram

__all__ = [
    "FALLBACKS", "StageFailure", "StageTimeoutError", "StageDispatchError",
    "run_partitioned_mesh", "validate_stage_decomposition",
    "mesh_program_cache_info", "clear_mesh_program_cache",
]

#: terminal-stage-failure behaviours of ``run_partitioned_mesh``
FALLBACKS = ("raise", "local")
#: how long ``fallback="local"`` waits for the worker of a timed-out stage
#: to finish before it runs the local executor on the same device
ABANDONED_JOIN_S = 120.0


class StageFailure(RuntimeError):
    """Base of the mesh executor's fault exceptions (a dispatched pipeline
    stage did not complete)."""


class StageTimeoutError(StageFailure):
    """A stage exceeded ``stage_timeout_s``.  Timeouts are counted in
    ``ExecStats.timeouts`` but never retried: a hung stream stays hung,
    and dispatching again just queues more work behind it."""


class StageDispatchError(StageFailure):
    """A stage dispatch raised and exhausted its ``stage_retries``
    re-attempts (each re-attempt is counted in ``ExecStats.retries``)."""


def _timeout_message(label: str, timeout_s: float, nodes: int) -> str:
    return (
        f"mesh stage {label!r} exceeded stage_timeout_s={timeout_s:g}s "
        f"({nodes} plan nodes). Likely causes, most common first: "
        f"(1) the first call of a stage program, which builds and loads "
        f"the kernels it launches and runs eagerly — warm the program "
        f"cache with one untimed run or raise the timeout; "
        f"(2) a CUDA graph capture that has not finished (a stage "
        f"program's second call captures it); "
        f"(3) a hung stream: a node's kernel that never completes; "
        f"(4) a lost device — pass fallback='local' to degrade to the "
        f"single-process engine instead of raising."
    )


# ---------------------------------------------------------------------------
# stage programs
# ---------------------------------------------------------------------------

class _StageProgram:
    """One cached stage: ``body(weights, inputs, marks)`` over ``n`` nodes,
    where ``marks(nd)`` is called on node ``nd``'s stream when its branch
    is done.  On the card it runs as a :class:`GraphProgram` that holds
    the weights its graph bakes in; on the CPU ``body`` runs at each call.

    A ``timed`` program on the card records a start event and one event a
    node (``marks``) in its body.  They are external events, which a
    capture records as nodes of the graph, so every replay times itself:
    :meth:`done_s` reads each node's completion after the call."""

    def __init__(self, body, weights: Sequence, inputs: Sequence, n: int,
                 timed: bool):
        self.body = body
        self.graph = None
        self.events = None
        if inputs[0].is_cuda:
            ws = tuple(weights)
            fn = lambda *a: body(ws, a, None)
            if timed:
                self.events = [torch.cuda.Event(enable_timing=True,
                                                external=True)
                               for _ in range(n + 1)]
                fn = lambda *a: self._timed(ws, a)
            self.graph = GraphProgram(
                fn, *(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                      for t in inputs))

    def _timed(self, ws, inputs):
        start, ends = self.events[0], self.events[1:]
        start.record()
        marked = set()

        def marks(nd):
            ends[nd].record()
            marked.add(nd)
        out = self.body(ws, inputs, marks)
        # a stage that does not fork (a merge) finishes every node's copy
        # of its replicated output at its end
        for nd in range(len(ends)):
            if nd not in marked:
                ends[nd].record()
        return out

    def __call__(self, weights: Sequence, inputs: Sequence, marks=None):
        """The stage's outputs; on the card they lie in the graph's memory
        and the program's next call overwrites them."""
        if self.graph is None:
            return self.body(weights, inputs, marks)
        return self.graph(*inputs)

    def done_s(self) -> Optional[Tuple[float, ...]]:
        """Each node's completion, in seconds from the stage's start, of
        the last call of a timed program on the card (after a
        synchronize); None otherwise."""
        if self.events is None:
            return None
        return tuple(self.events[0].elapsed_time(e) / 1e3
                     for e in self.events[1:])


_PROGRAMS: Dict[tuple, _StageProgram] = {}
_PROGRAM_STATS = {"hits": 0, "misses": 0}


def mesh_program_cache_info() -> SegmentCacheInfo:
    """(hits, misses, maxsize, currsize) of the stage-program cache;
    ``maxsize`` is None: the cache is unbounded."""
    return SegmentCacheInfo(_PROGRAM_STATS["hits"],
                            _PROGRAM_STATS["misses"], None, len(_PROGRAMS))


def clear_mesh_program_cache() -> None:
    """Drop every stage program (and its graph and memory) and zero the
    counts."""
    _PROGRAMS.clear()
    _PROGRAM_STATS.update(hits=0, misses=0)


# ---------------------------------------------------------------------------
# axis-generic helpers (InH splits rows, InW splits columns)
# ---------------------------------------------------------------------------

def _slc(x, a: int, b: int, axis: int):
    return x[a:b] if axis == 0 else x[:, a:b]


def _cat(parts, axis: int):
    parts = [p for p in parts if p is not None and p.shape[axis] > 0]
    if len(parts) == 1:
        return parts[0]
    return torch.cat(parts, dim=axis)


# ---------------------------------------------------------------------------
# carried state between pipeline stages
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Full:
    """Boundary tensor replicated on the mesh: one tensor on its one
    device, which every node reads."""

    arr: torch.Tensor


@dataclasses.dataclass
class _Rows:
    """Sharded 1-D spatial layout: node ``n`` holds rows/cols
    ``ranges[n]`` of the boundary tensor (``blocks[n]``), plus the halo
    blocks received from its neighbors for the next segment."""

    blocks: List[torch.Tensor]
    axis: int                            # 0 = rows (InH), 1 = cols (InW)
    ranges: Tuple[Tuple[int, int], ...]
    up: List[torch.Tensor]               # [h_up, ...] from node n - 1
    dn: List[torch.Tensor]               # [h_dn, ...] from node n + 1
    halo: Tuple[int, int]


@dataclasses.dataclass
class _Cells:
    """Sharded exact-region layout: node ``n`` owns ``cells[n]`` of the
    boundary tensor, ``tensors[n][j]`` the data of its ``j``-th cell."""

    tensors: List[List[torch.Tensor]]
    cells: Tuple[Tuple[Rect, ...], ...]
    shape: Tuple[int, int, int]          # full boundary tensor shape


@dataclasses.dataclass(frozen=True)
class _CellProg:
    reg: Rect
    in_rect: Rect
    recs: tuple


@dataclasses.dataclass(frozen=True)
class _RowsPlan:
    """Permute-compatible boundary: per-node owned ranges plus the global
    halo sizes the exchange must carry."""

    axis: int
    ranges: Tuple[Tuple[int, int], ...]
    h_up: int
    h_dn: int


def permute_plan(layers: Sequence[LayerSpec], regs_b, a2: int, b2: int,
                 scheme: Scheme, q2: Scheme,
                 nodes: int) -> Optional[_RowsPlan]:
    """Neighbor-exchange eligibility of the boundary into segment
    ``[a2..b2]`` (scheme ``q2``) from a segment of ``scheme`` whose
    per-node output regions are ``regs_b``: the same 1-D spatial scheme on
    both sides, and every node's next input rect contained in its own and
    its immediate neighbors' ranges."""
    if nodes == 1 or scheme != q2 or q2 not in (Scheme.INH, Scheme.INW):
        return None
    axis = 0 if q2 == Scheme.INH else 1
    ranges = tuple(cells[0][axis] for cells in regs_b)
    next_regs = exact_regions(layers[b2], q2, nodes)
    h_up = h_dn = 0
    for nd in range(nodes):
        _, in_rect = backward_chain(layers, a2, b2, next_regs[nd][0])
        i0, i1 = in_rect[axis]
        o0, o1 = ranges[nd]
        h_up = max(h_up, o0 - i0)
        h_dn = max(h_dn, i1 - o1)
    h_up, h_dn = max(h_up, 0), max(h_dn, 0)
    if min(r1 - r0 for r0, r1 in ranges) < max(h_up + h_dn, 1):
        return None
    return _RowsPlan(axis, ranges, h_up, h_dn)


def strip_regions(reg: Rect, rp: _RowsPlan) -> List[Optional[Rect]]:
    """(top, interior, bottom) strips of a node's output region ``reg``
    under an overlapped exchange: the top ``h_dn`` rows its upper neighbor
    needs, the bottom ``h_up`` rows its lower neighbor needs, and the rest;
    None for an empty strip."""
    axis = rp.axis
    r0, r1 = reg[axis]
    t1 = min(r0 + rp.h_dn, r1)
    b0 = max(r1 - rp.h_up, t1)
    return [tuple((s0, s1) if i == axis else reg[i] for i in range(3))
            if s1 > s0 else None
            for s0, s1 in ((r0, t1), (t1, b0), (b0, r1))]


def _entry_slice(kind: str, meta, nd: int, in_rect: Rect, inputs,
                 n: int) -> torch.Tensor:
    """The halo-extended local input slice of node ``nd``'s segment: from
    the replicated tensor (gather path) or from the node's own rows and the
    halos it received (permute path), concatenated only where the slice
    spans more than one of them."""
    if kind == "full":
        (r, c, _) = in_rect
        return inputs[0][r[0]:r[1], c[0]:c[1], :]
    axis, ranges, h_up, _ = meta
    o0, o1 = ranges[nd]
    i0, i1 = in_rect[axis]
    x_rows, u, d = inputs[nd], inputs[n + nd], inputs[2 * n + nd]
    pieces = []
    for t, start in ((u, o0 - h_up), (x_rows, o0), (d, o1)):
        a, b = max(i0, start), min(i1, start + t.shape[axis])
        if b > a:
            pieces.append(_slc(t, a - start, b - start, axis))
    if not pieces:
        return _slc(x_rows, 0, 0, axis)
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=axis)


def _put_cells(fulls, metas, inputs):
    """The per-node branch that copies node ``nd``'s cells, on its stream,
    into the replicated tensors ``fulls`` (``metas[i]`` the per-node cells
    of ``fulls[i]``; their tensors in ``inputs``, tensor after tensor in
    node order)."""
    offsets, off = [], 0
    for cells in metas:
        offsets.append(off)
        off += sum(len(c) for c in cells)

    def put(nd):
        for full, cells, o in zip(fulls, metas, offsets):
            j = o + sum(len(c) for c in cells[:nd])
            for (r, c, ch) in cells[nd]:
                if r[1] > r[0] and c[1] > c[0] and ch[1] > ch[0]:
                    full[r[0]:r[1], c[0]:c[1], ch[0]:ch[1]].copy_(inputs[j])
                j += 1
    return put


def _entry_args(state) -> Tuple[str, object, tuple]:
    """(kind, static entry meta, input tensors) of a compute stage: the
    replicated tensor, or every node's rows, then up halos, then down
    halos."""
    if isinstance(state, _Full):
        return "full", None, (state.arr,)
    meta = (state.axis, state.ranges) + state.halo
    return "rows", meta, tuple(state.blocks) + tuple(state.up) + \
        tuple(state.dn)


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------

class _MeshRun:
    def __init__(self, mesh: NodesMesh, nodes: int,
                 device: torch.device, backend: str, instrument: bool,
                 overlap: bool, stats: ExecStats,
                 stage_timeout_s: Optional[float] = None,
                 stage_retries: int = 0,
                 fault_hook: Optional[Callable[[str, str, int],
                                               None]] = None) -> None:
        self.nodes = mesh
        self.n = nodes
        self.device = device
        self.backend = backend
        self.instrument = instrument
        self.overlap = overlap
        self.stats = stats
        self.stage_timeout_s = stage_timeout_s
        self.stage_retries = stage_retries
        self.fault_hook = fault_hook
        self.seen: collections.Counter = collections.Counter()
        # observability: the tracer is cached once a run (None = tracing
        # off, the zero-overhead default); the flight ring is always on —
        # host-side appends never touch the numbers, so runs stay
        # bit-identical
        self.tracer = _obs_trace.get_tracer()
        self.flight = _obs_flight.get_flight()
        #: the worker of a stage that timed out, which may still be
        #: running it
        self.abandoned: Optional[threading.Thread] = None

    # -- stage programs ----------------------------------------------------

    def _stage(self, kind: str, label: str, sig: tuple, body, ws,
               inputs: Sequence[torch.Tensor]):
        """Dispatch one stage program, from the cache or made.  The key is
        the static signature, what a CUDA graph bakes in (each weight's
        pointer, shape and stride; each input's shape and dtype; the
        device; the timing events of ``instrument``) and the program's
        occurrence in this run."""
        base = (sig, str(self.device), self.n, self.backend, self.overlap,
                self.instrument, tuple(_weight_key(w) for w in ws),
                tuple((tuple(t.shape), t.dtype) for t in inputs))
        key = base + (self.seen[base],)
        self.seen[base] += 1
        prog = _PROGRAMS.get(key)
        if prog is None:
            _PROGRAM_STATS["misses"] += 1
            prog = _PROGRAMS[key] = _StageProgram(body, ws, inputs, self.n,
                                                  self.instrument)
        else:
            _PROGRAM_STATS["hits"] += 1
        return self._dispatch(kind, label,
                              lambda marks: prog(ws, inputs, marks), prog)

    # -- dispatch + instrumentation ---------------------------------------

    def _dispatch(self, kind: str, label: str, call, prog=None):
        """Run one pipeline stage with the fault policy: a stage that
        exceeds ``stage_timeout_s`` raises :class:`StageTimeoutError`
        (counted, never retried); any other exception is re-attempted up
        to ``stage_retries`` times (each counted) before
        :class:`StageDispatchError`.  ``fault_hook`` is a test seam called
        as ``(kind, label, attempt)`` before every attempt — raising from
        it injects a deterministic fault.

        Every dispatch rides the flight ring; terminal failures dump a
        postmortem artifact (``obs.flight.dump_postmortem`` — a no-op
        unless a postmortem directory is configured)."""
        attempt = 0
        self.flight.record("stage_dispatch", stage_kind=kind,
                           label=label)
        while True:
            try:
                if self.fault_hook is not None:
                    self.fault_hook(kind, label, attempt)
                return self._execute(kind, label, call, prog)
            except StageTimeoutError:
                self.stats.timeouts += 1
                self.flight.record("stage_timeout", stage_kind=kind,
                                   label=label,
                                   timeout_s=self.stage_timeout_s)
                _obs_flight.dump_postmortem(
                    "stage_timeout",
                    context={"kind": kind, "label": label,
                             "timeout_s": self.stage_timeout_s,
                             "nodes": self.n, "attempt": attempt})
                raise
            except StageFailure as exc:
                self.flight.record("stage_failure", stage_kind=kind,
                                   label=label)
                _obs_flight.dump_postmortem(
                    "stage_failure",
                    context={"kind": kind, "label": label,
                             "nodes": self.n, "attempt": attempt,
                             "error": repr(exc)})
                raise
            except Exception as exc:
                if attempt >= self.stage_retries:
                    self.flight.record("stage_dispatch_error",
                                       stage_kind=kind,
                                       label=label, attempts=attempt + 1)
                    _obs_flight.dump_postmortem(
                        "stage_dispatch_error",
                        context={"kind": kind, "label": label,
                                 "nodes": self.n,
                                 "attempts": attempt + 1,
                                 "stage_retries": self.stage_retries,
                                 "error": repr(exc)})
                    raise StageDispatchError(
                        f"mesh stage {label!r} failed after "
                        f"{attempt + 1} attempt(s) "
                        f"(stage_retries={self.stage_retries}): "
                        f"{exc!r}") from exc
                self.stats.retries += 1
                self.flight.record("stage_retry", stage_kind=kind,
                                   label=label,
                                   attempt=attempt)
                if self.tracer is not None:
                    self.tracer.instant(_obs_trace.CONTROL_TRACK,
                                        f"retry:{label}", cat="retry",
                                        attempt=attempt)
                attempt += 1

    def _sync(self) -> None:
        """Wait for the stage: the calling stream has joined every node
        stream, so its completion is the stage's."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _watched(self, label: str, body):
        """Run ``body`` under the per-stage watchdog: a daemon worker
        thread does the work, on the caller's device and stream (PyTorch
        keeps both per thread), while this thread joins with
        ``stage_timeout_s``.  A hung stream cannot be interrupted — on
        timeout the worker is abandoned (daemonized, so it cannot hang
        interpreter exit) and :class:`StageTimeoutError` surfaces."""
        timeout = self.stage_timeout_s
        box: Dict[str, object] = {}
        stream = torch.cuda.current_stream(self.device) \
            if self.device.type == "cuda" else None

        def worker():
            try:
                if stream is None:
                    box["out"] = body()
                    return
                with torch.cuda.device(self.device), \
                        torch.cuda.stream(stream):
                    box["out"] = body()
            except BaseException as exc:    # noqa: BLE001 — re-raised
                box["err"] = exc

        th = threading.Thread(target=worker, daemon=True,
                              name=f"mesh-stage:{label}")
        th.start()
        th.join(timeout)
        if th.is_alive():
            self.abandoned = th
            raise StageTimeoutError(
                _timeout_message(label, timeout, self.n))
        if "err" in box:
            raise box["err"]
        return box["out"]

    def settle(self) -> None:
        """Before the fallback reuses the device: wait up to
        :data:`ABANDONED_JOIN_S` for the worker of a timed-out stage,
        which may still be capturing a graph (work of another thread on
        the device during a capture invalidates it), then for the work it
        enqueued.  A worker that is still alive then refuses the fallback
        with :class:`StageTimeoutError`."""
        th = self.abandoned
        if th is None:
            return
        th.join(ABANDONED_JOIN_S)
        if th.is_alive():
            raise StageTimeoutError(
                f"mesh stage worker {th.name!r} still runs "
                f"{ABANDONED_JOIN_S:g}s after its timeout: fallback='local' "
                f"refused, since the local executor would share the device "
                f"with it")
        self.abandoned = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _execute(self, kind: str, label: str, call,
                 prog: Optional[_StageProgram] = None):
        timed = self.stage_timeout_s is not None
        if not self.instrument:
            def body():
                out = call(None)
                # the stage is enqueued, not done: with a watchdog armed
                # it must finish inside the worker for the timeout to see
                # its execution
                if timed:
                    self._sync()
                return out
            return self._watched(label, body) if timed else body()

        def body():
            # node completion: on the card the program's own events (in
            # its graph once captured), on the CPU the host clock as each
            # node's branch ends, the nodes running one after another
            n = self.n
            done: List[Optional[float]] = [None] * n
            tr = self.tracer
            t0 = time.perf_counter()
            t0_us = tr.now_us() if tr is not None else 0.0

            def marks(nd):
                done[nd] = time.perf_counter() - t0
            out = call(marks)
            self._sync()
            wall = time.perf_counter() - t0
            dev_done: Tuple[float, ...] = ()
            if kind == "compute" and n > 1:
                on_card = prog.done_s() if prog is not None else None
                dev_done = on_card if on_card is not None else tuple(
                    wall if d is None else d for d in done)
            self.stats.stage_times.append(
                StageTime(kind, label, wall, dev_done))
            if tr is not None:
                # one control-track stage span per StageTime row (the
                # 1:1 contract), plus a per-node span bounded by each
                # node's completion time
                tr.add_complete(_obs_trace.CONTROL_TRACK, label, t0_us,
                                wall * 1e6, cat=_obs_trace.STAGE_CAT,
                                args={"kind": kind})
                for d, done_s in enumerate(dev_done):
                    tr.add_complete(_obs_trace.device_track(d), label,
                                    t0_us, done_s * 1e6, cat="device",
                                    args={"kind": kind})
            return out
        return self._watched(label, body) if timed else body()

    # -- compute stage: segment -> cells ----------------------------------

    def _seg_to_cells(self, label: str, ws, state,
                      cellprogs: List[List[_CellProg]],
                      out_shape: Tuple[int, int, int]) -> _Cells:
        kind, meta, inputs = _entry_args(state)
        backend, nodes, n = self.backend, self.nodes, self.n

        def body(ws, inputs, marks):
            def branch(nd):
                return [_run_records(cp.recs, ws,
                                     _entry_slice(kind, meta, nd, cp.in_rect,
                                                  inputs, n), backend)
                        for cp in cellprogs[nd]]
            return nodes.run(branch, marks=marks)

        sig = ("seg2cells", kind, meta,
               tuple(tuple(ps) for ps in cellprogs))
        tensors = self._stage("compute", label, sig, body, ws, inputs)
        cells = tuple(tuple(cp.reg for cp in ps) for ps in cellprogs)
        return _Cells(tensors=tensors, cells=cells, shape=out_shape)

    # -- compute stage: segment -> rows (+ overlapped halo exchange) ------

    def _seg_to_rows(self, label: str, bound_label: str, layers, a: int,
                     b: int, ws, state, cellprogs: List[List[_CellProg]],
                     rp: _RowsPlan) -> _Rows:
        kind, meta, inputs = _entry_args(state)
        backend, nodes, n, axis = self.backend, self.nodes, self.n, rp.axis
        use_overlap = self.overlap and (rp.h_up > 0 or rp.h_dn > 0)
        halos = (rp.h_up, rp.h_dn)
        if not use_overlap:
            def body(ws, inputs, marks):
                def branch(nd):
                    cp = cellprogs[nd][0]
                    return _run_records(
                        cp.recs, ws, _entry_slice(kind, meta, nd, cp.in_rect,
                                                  inputs, n), backend)
                return nodes.run(branch, marks=marks)

            sig = ("seg2rows", kind, meta, axis, rp.ranges, halos,
                   tuple(cellprogs[nd][0] for nd in range(n)))
            blocks = self._stage("compute", label, sig, body, ws, inputs)
            # the exchange is its own sync stage, one to one with the
            # simulator's boundary stage
            up, dn = self._halo_sync_stage(bound_label, blocks, rp)
            return _Rows(blocks, axis, rp.ranges, up, dn, halos)

        lb = layers[b]
        other = lb.out_w if axis == 0 else lb.out_h

        def halo_shape(h):
            return (h, other, lb.out_c) if axis == 0 else (other, h, lb.out_c)

        strips = []
        for nd in range(n):
            cp = cellprogs[nd][0]
            recs = []
            for reg in strip_regions(cp.reg, rp):
                if reg is None:
                    recs.append(None)
                    continue
                need, _ = backward_chain(layers, a, b, reg)
                recs.append(_segment_records(layers, a, b, need, cp.in_rect))
            strips.append((cp.in_rect, tuple(recs)))

        def body(ws, inputs, marks):
            border = {}

            def borders(nd):
                # the strips the neighbors need first, then the event
                # their copies wait on, before the interior is enqueued
                in_rect, (top, _, bot) = strips[nd]
                xs = _entry_slice(kind, meta, nd, in_rect, inputs, n)
                outs = [None if recs is None
                        else _run_records(recs, ws, xs, backend)
                        for recs in (top, bot)]
                border[nd] = (xs, outs, nodes.event())

            def interior(nd):
                xs, (top, bot), _ = border[nd]
                mid = strips[nd][1][1]
                y = _cat([top, None if mid is None
                          else _run_records(mid, ws, xs, backend), bot], axis)
                dt = y.dtype
                up = torch.zeros(halo_shape(rp.h_up), dtype=dt,
                                 device=y.device) if nd == 0 or not rp.h_up \
                    else nodes.receive(border[nd - 1][1][1], nd,
                                       border[nd - 1][2])
                dn = torch.zeros(halo_shape(rp.h_dn), dtype=dt,
                                 device=y.device) \
                    if nd == n - 1 or not rp.h_dn \
                    else nodes.receive(border[nd + 1][1][0], nd,
                                       border[nd + 1][2])
                return y, up, dn
            return nodes.run(borders, interior, marks=marks)

        sig = ("seg2rows-overlap", kind, meta, axis, rp.ranges, halos,
               tuple(strips))
        res = self._stage("compute", label, sig, body, ws, inputs)
        return _Rows([r[0] for r in res], axis, rp.ranges,
                     [r[1] for r in res], [r[2] for r in res], halos)

    def _halo_sync_stage(self, label: str, blocks, rp: _RowsPlan):
        nodes, n, axis = self.nodes, self.n, rp.axis
        if not rp.h_up and not rp.h_dn:
            # nothing to exchange (FC rows): empty halos, no program
            empty = [_slc(blk, 0, 0, axis) for blk in blocks]
            return self._dispatch("sync", label,
                                  lambda marks: (empty, list(empty)))

        def body(ws, inputs, marks):
            def recv(nd):
                # node 0's up and the last node's down halo are zero
                # blocks, as ppermute leaves them
                x = inputs[nd]
                up = _slc(inputs[nd - 1], -rp.h_up, None, axis) \
                    if nd > 0 and rp.h_up else _slc(x, 0, rp.h_up, axis)
                dn = _slc(inputs[nd + 1], 0, rp.h_dn, axis) \
                    if nd < n - 1 else _slc(x, 0, rp.h_dn, axis)
                return (up.clone() if nd > 0 else torch.zeros_like(up),
                        dn.clone() if nd < n - 1 else torch.zeros_like(dn))
            res = nodes.run(recv, marks=marks)
            return [r[0] for r in res], [r[1] for r in res]

        sig = ("halo_sync", axis, rp.ranges, rp.h_up, rp.h_dn)
        return self._stage("sync", label, sig, body, (), tuple(blocks))

    # -- sync stage: cells -> replicated full -----------------------------

    def _gather_stage(self, label: str, state: _Cells) -> _Full:
        cells, shape, nodes = state.cells, state.shape, self.nodes
        inputs = tuple(t for ts in state.tensors for t in ts)

        def body(ws, inputs, marks):
            full = inputs[0].new_zeros(shape)
            nodes.run(_put_cells([full], [cells], inputs), marks=marks)
            return full

        sig = ("gather", cells, shape)
        return _Full(self._stage("sync", label, sig, body, (), inputs))

    # -- merge stages ------------------------------------------------------

    def _merge_stages(self, l_m: LayerSpec, prods: Sequence[int],
                      outs: Dict[int, object], x_full) -> _Full:
        """One sync stage gathering every producer's shards (the
        simulator's single per-merge delivery stage) followed by the merge
        layer's own singleton compute stage."""
        metas, inputs = [], []
        for pid in prods:
            if pid != -1:
                st = outs[pid]
                assert isinstance(st, _Cells)
                metas.append((st.cells, st.shape))
                inputs.extend(t for ts in st.tensors for t in ts)
        with_x = -1 in prods
        if with_x:
            inputs.append(x_full)
        nodes = self.nodes

        def body(ws, inputs, marks):
            fulls = [inputs[0].new_zeros(shape) for _, shape in metas]
            nodes.run(_put_cells(fulls, [c for c, _ in metas], inputs),
                      marks=marks)
            it = iter(fulls)
            return tuple(inputs[-1] if pid == -1 else next(it)
                         for pid in prods)

        sig = ("merge", tuple(prods), tuple(metas), with_x)
        fulls = self._stage("sync", f"merge->{l_m.name}", sig, body, (),
                            tuple(inputs))

        def mbody(ws, inputs, marks):
            return merge_tensors(l_m, list(inputs))

        msig = ("merge_apply", l_m.conv_t)
        return _Full(self._stage("compute", f"seg[{l_m.name}..{l_m.name}]",
                                 msig, mbody, (), fulls))

    def _full_to_cells(self, state: _Full, owned,
                       shape: Tuple[int, int, int]) -> _Cells:
        """Re-shard a replicated tensor into its owned layout (merge-only
        branches: the merged tensor is replicated but downstream consumers
        expect the branch tail in shard form).  Each node's cells are
        views of the replicated tensor: no copy, no program."""
        cells = tuple(tuple(owned[nd]) for nd in range(self.n))
        arr = state.arr

        def call(marks):
            return [[arr[r[0]:r[1], c[0]:c[1], ch[0]:ch[1]]
                     for (r, c, ch) in cs] for cs in cells]
        tensors = self._dispatch("sync", "reshard", call)
        return _Cells(tensors=tensors, cells=cells, shape=shape)

    # -- branch execution --------------------------------------------------

    def run_branch(self, layers: Sequence[LayerSpec], weights,
                   steps, state, owned):
        segs = steps_segments(list(steps))
        regs_b = None
        for si, (a, b) in enumerate(segs):
            scheme = steps[a][0]
            lb = layers[b]
            regs_b = exact_regions(lb, scheme, self.n)
            cellprogs: List[List[_CellProg]] = []
            computed = 0
            for nd, cells in enumerate(regs_b):
                ps = []
                for reg in cells:
                    need, in_rect = backward_chain(layers, a, b, reg)
                    if owned is not None:
                        held = sum(_rect_elems(_rect_isect(in_rect, o))
                                   for o in owned[nd])
                        self.stats.bytes_received += DTYPE_BYTES * (
                            _rect_elems(in_rect) - held)
                    for li in range(a, b):
                        computed += _rect_elems(need[li])
                    ps.append(_CellProg(
                        reg, in_rect,
                        _segment_records(layers, a, b, need, in_rect)))
                cellprogs.append(ps)
            self.stats.sync_points += 1
            self.stats.redundant_elems += float(computed)
            self.stats.compute_stages += 1
            label = f"seg[{layers[a].name}..{layers[b].name}]"

            rows_plan = None
            if si + 1 < len(segs):
                a2, b2 = segs[si + 1]
                rows_plan = permute_plan(layers, regs_b, a2, b2, scheme,
                                         steps[a2][0], self.n)
            ws = tuple(weights[a:b + 1])
            out_shape = (lb.out_h, lb.out_w, lb.out_c)
            if rows_plan is None:
                state = self._seg_to_cells(label, ws, state, cellprogs,
                                           out_shape)
                if si + 1 < len(segs):
                    state = self._gather_stage(f"bound@{lb.name}", state)
            else:
                state = self._seg_to_rows(label, f"bound@{lb.name}",
                                          layers, a, b, ws, state,
                                          cellprogs, rows_plan)
            owned = regs_b
        assert regs_b is not None, "branch must contain >= 1 segment"
        return state, owned


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def _run_degraded(graph: ModelGraph, weights, x, plan: Plan, nodes: int,
                  backend: str, stats: ExecStats
                  ) -> Tuple[torch.Tensor, ExecStats]:
    """Degraded single-process fallback: execute the plan with the local
    executor on the same device and carry the mesh run's failure counters
    over, so that ``ExecStats.failure_count`` (and through it
    ``MeasuredOccupancy.failures``) records the degradation."""
    _obs_flight.get_flight().record("fallback_local",
                                    graph=graph.name, nodes=nodes)
    out, local_stats = _run_partitioned_local(graph, weights, x, plan,
                                              nodes, backend=backend)
    local_stats.retries = stats.retries
    local_stats.timeouts = stats.timeouts
    local_stats.fallbacks = stats.fallbacks + 1
    return out, local_stats


def run_partitioned_mesh(graph: ModelGraph, weights, x: torch.Tensor,
                         plan: Plan, nodes: int, *,
                         backend: str = "cuda",
                         mesh: Optional[NodesMesh] = None,
                         devices: Optional[Sequence] = None,
                         instrument: bool = False,
                         overlap: bool = True,
                         stage_timeout_s: Optional[float] = None,
                         stage_retries: int = 0,
                         fallback: str = "raise",
                         fault_hook: Optional[Callable[[str, str, int],
                                                       None]] = None
                         ) -> Tuple[torch.Tensor, ExecStats]:
    """Execute ``plan`` with each planned node's programs on its own
    stream of ``x``'s device (see the module docstring).  Returns the
    reassembled full output and ``ExecStats`` whose geometry accounting
    equals the local executor's; with ``instrument=True`` the stats also
    carry per-stage wall times and, for compute stages, each node's
    completion (on the card run three times and read the third run's
    stats: a program's first call runs eagerly, its second captures).

    ``mesh`` is a prebuilt :class:`~repro_torch.launch.mesh.NodesMesh`;
    without one the run builds it over ``devices`` (default
    ``[x.device]``, the one-card mapping).  Fault handling:
    ``stage_timeout_s`` arms a per-stage watchdog (it covers a program's
    first call, which runs eagerly, and its capture); ``stage_retries``
    bounds re-dispatches of a failed stage; ``fallback="local"`` degrades
    to the local executor instead of raising when the devices cannot hold
    the mesh or a stage fails terminally — after a timeout only once the
    abandoned stage worker has finished (:meth:`_MeshRun.settle`).
    ``fault_hook(kind, label,
    attempt)`` is called before every stage attempt, a test seam for
    deterministic fault injection.  ``ExecStats.retries/timeouts/
    fallbacks`` record what happened."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if nodes < 1:
        raise ValueError(f"nodes must be >= 1, got {nodes}")
    if fallback not in FALLBACKS:
        raise ValueError(f"fallback {fallback!r} not in {FALLBACKS}")
    if stage_retries < 0:
        raise ValueError(f"stage_retries must be >= 0, got {stage_retries}")
    if stage_timeout_s is not None and stage_timeout_s <= 0:
        raise ValueError(
            f"stage_timeout_s must be > 0, got {stage_timeout_s}")
    stats = ExecStats()
    if mesh is None:
        try:
            mesh = make_nodes_mesh(
                nodes, [x.device] if devices is None else devices)
        except RuntimeError:
            # mesh shrink: the devices cannot hold the plan's nodes —
            # degrade instead of failing, if asked to
            if fallback != "local":
                raise
            return _run_degraded(graph, weights, x, plan, nodes, backend,
                                 stats)
    check_mesh(mesh, nodes, x.device)
    run = _MeshRun(mesh, nodes, x.device, backend, instrument, overlap,
                   stats, stage_timeout_s, stage_retries, fault_hook)
    try:
        return _mesh_body(run, graph, weights, x, plan, nodes, stats)
    except StageFailure:
        if fallback != "local":
            raise
        run.settle()
        return _run_degraded(graph, weights, x, plan, nodes, backend,
                             stats)


def _mesh_body(run: _MeshRun, graph: ModelGraph, weights, x, plan: Plan,
               nodes: int, stats: ExecStats
               ) -> Tuple[torch.Tensor, ExecStats]:
    t0 = time.perf_counter()

    if graph.is_chain:
        plan.validate()
        if len(plan) != len(graph):
            raise ValueError("plan/graph length mismatch")
        state, _ = run.run_branch(graph.layers, weights, plan.steps,
                                  _Full(x), None)
        final = run._gather_stage("gather", state)
    else:
        plan.validate_for(graph)
        layers = graph.layers
        outs: Dict[int, object] = {}
        owned_map: Dict[int, Optional[List[List[Rect]]]] = {-1: None}
        final = None
        for br in graph.linearize():
            ids = list(br.ids)
            head = ids[0]
            prods = graph.producer_ids[head]
            if len(prods) >= 2:
                l_m = layers[head]
                q = plan.steps[head][0]
                regs = exact_regions(l_m, q, nodes)
                stats.sync_points += 1
                stats.compute_stages += 1
                stats.bytes_received += _merge_comm_bytes(
                    l_m, prods,
                    [layers[p].out_c if p >= 0 else layers[0].in_c
                     for p in prods],
                    owned_map, regs)
                cur = run._merge_stages(l_m, prods, outs, x)
                owned = regs
                rest = ids[1:]
            else:
                src = prods[0]
                if src == -1:
                    cur, owned = _Full(x), None
                else:
                    tail = outs[src]
                    assert isinstance(tail, _Cells)
                    cur = run._gather_stage(f"fork->{layers[head].name}",
                                            tail)
                    owned = owned_map[src]
                rest = ids
            if rest:
                ls = [layers[i] for i in rest]
                ws = [weights[i] for i in rest]
                st = [plan.steps[i] for i in rest]
                cur, owned = run.run_branch(ls, ws, st, cur, owned)
            if isinstance(cur, _Full):
                # merge-only branch (no trailing layers): re-shard the
                # replicated tensor into the merge layout for consumers
                last = layers[ids[-1]]
                cur = run._full_to_cells(cur, owned, (last.out_h,
                                                      last.out_w,
                                                      last.out_c))
            elif isinstance(cur, _Rows):
                raise AssertionError("branch tails always exit as cells")
            outs[ids[-1]] = cur
            owned_map[ids[-1]] = owned
            if not graph.consumer_ids[ids[-1]]:
                final = run._gather_stage("gather", cur)
        assert final is not None
    # a replayed program's output lies in its graph's memory, which the
    # next run overwrites: the caller gets a copy
    out = final.arr.clone()
    run._sync()
    stats.wall_s = time.perf_counter() - t0
    return out, stats


# ---------------------------------------------------------------------------
# stage-decomposition validation against the simulator
# ---------------------------------------------------------------------------

def validate_stage_decomposition(stats: ExecStats, stages) -> dict:
    """Compare the measured stage DAG (mesh executor with
    ``instrument=True, overlap=False``) against the reference simulator's
    ``cluster.simsched.build_stages``: the (kind, label) multisets must
    match one to one; per-stage durations are paired up for inspection
    but never asserted here.

    Two physical-vs-model equivalences are applied before comparing:

    * ``reshard`` stages (merge-only branch re-sharding, a pure local
      slice) are ignored — the simulator has no counterpart because they
      move no bytes;
    * a sim ``bound@X`` where ``X`` is a merge layer is *subsumed* by the
      measured ``merge->X`` stage — the mesh merge gather leaves the merged
      tensor replicated, so the simulator's post-merge distribution
      boundary has no separate physical stage.  Subsumed stages are
      reported in ``subsumed``, not ``missing``."""
    meas = collections.Counter((s.kind, s.label) for s in stats.stage_times
                               if s.label != "reshard")
    sim = collections.Counter((s.kind, s.label) for s in stages)
    merge_names = {s.label[len("merge->"):] for s in stages
                   if s.kind == "sync" and s.label.startswith("merge->")}
    subsumed = []
    for name in merge_names:
        key = ("sync", f"bound@{name}")
        k = sim[key] - meas[key]
        if k > 0:
            sim[key] -= k
            subsumed.extend([key] * k)
    missing = sorted((sim - meas).elements())
    extra = sorted((meas - sim).elements())
    per_stage = []
    meas_by: Dict[tuple, list] = {}
    for s in stats.stage_times:
        meas_by.setdefault((s.kind, s.label), []).append(s.wall_s)
    for s in stages:
        walls = meas_by.get((s.kind, s.label), [])
        per_stage.append({
            "kind": s.kind, "label": s.label,
            "sim_s": max(s.durations) if s.durations else 0.0,
            "measured_s": walls.pop(0) if walls else None,
        })
    return {"structure_match": not missing and not extra,
            "missing": missing, "extra": extra,
            "subsumed": sorted(subsumed), "stages": per_stage}
