"""Distributed edge-inference engine: executes a FlexPie Plan on real
tensors, node by node, and verifies exact reassembly.

Each simulated edge node computes only from data it actually holds: the
engine backward-chains the receptive field from the node's exact output
shard at the segment end (T layer) through every NT-fused layer, slices
that input region once at the segment entry (counting the bytes the node
did not own — the measured communication), then runs the whole segment
locally.  This exercises the paper's core mechanics end to end: halo
growth, redundant computation, scheme-dependent re-layout.

Branched graphs execute branch by branch (``ModelGraph.linearize()``):
every branch is a chain run through the same segment machinery, fork
outputs are read by each consuming branch, and merge layers (ADD/CONCAT)
reassemble their incoming branch shards at a forced sync point before the
next branch continues.

Correctness contract (tested against the JAX package): for ANY valid plan
— chain or DAG — the reassembled output equals the unpartitioned reference
inference, and ``ExecStats`` equals the reference engine's field for field.

Backends: ``"cuda"`` (default) dispatches every segment-layer record to the
hand-written shard kernels (``repro_torch.kernels``) — conv, depthwise and
pointwise shards consume their halo-extended local slice in place (zero
padding applied in the kernel, no padded copy) and FC layers run the tiled
matmul kernel; on CPU tensors the kernel wrappers run their plain versions.
Geometries the kernels cannot lower (POOL, degenerate shard outputs) fall
back to the generic ATen path per record.  ``"torch"`` is the generic ATen
lowering of every record (the reference's ``"xla"``).  Layouts are the
reference's at every public function: activations ``[H, W, C]`` without a
batch dimension (FC: ``[seq, 1, C]``), conv weights HWIO, depthwise weights
``[K, K, 1, C]``; only the ATen path permutes to NCHW/OIHW internally.

Segment programs (``jit_segments=True``, the default, as the reference's):
every segment cell runs through :func:`_compiled_segment`, a process-wide
cache of programs keyed by the cell's records and backend plus what a CUDA
graph bakes in — each weight's pointer, shape and stride, the input's
shape and dtype, and the device.  On the card a program holds its
weights, so a pointer its graph bakes in stays valid until
:func:`clear_segment_cache`; on the CPU it holds none and takes them at
each call, as the reference's programs do.  On the card a program
copies the cell's input (a strided view of the previous segment's freshly
allocated output, so never keyed by its pointer) into its own static
buffer and runs as a :class:`~repro_torch.runtime.graphs.
GraphProgram`: eager on its first call, captured on its second, replayed
after that.  Cells of one run can share a program (the interior cells of
an InH split have the same records and weights), so each cell's output is
copied into the reassembled tensor as soon as it is computed, before the
next replay overwrites it.  On CPU tensors a program runs its records
eagerly.  ``jit_segments=False`` runs every record eagerly on the card as
well.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.graph import ConvT, LayerSpec, ModelGraph
from repro_torch.core.partition import (DTYPE_BYTES, Mode, Scheme, grid_dims,
                                        split_sizes)
from repro_torch.core.plan import Plan, steps_segments
from repro_torch.kernels.conv2d import UnsupportedGeometry, conv2d_shard
from repro_torch.kernels.ops import matmul_tiled
from repro_torch.runtime.graphs import GraphProgram

Rect = Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]]

BACKENDS = ("torch", "cuda")
EXECUTORS = ("local", "mesh")


# ---------------------------------------------------------------------------
# Weights and reference (unpartitioned) inference
# ---------------------------------------------------------------------------

def _weight_shape(l: LayerSpec) -> Optional[Tuple[Tuple[int, ...], int]]:
    """(shape, fan-in) of layer ``l``'s weight, None for weightless
    layers — the reference engine's ``init_weights`` layout."""
    if l.conv_t in (ConvT.CONV, ConvT.POINTWISE):
        return (l.k, l.k, l.in_c, l.out_c), l.k * l.k * l.in_c
    if l.conv_t == ConvT.DWCONV:
        return (l.k, l.k, 1, l.in_c), l.k * l.k
    if l.conv_t == ConvT.FC:
        return (l.in_c, l.out_c), l.in_c
    return None


def init_weights(graph: ModelGraph, generator: torch.Generator,
                 device="cuda") -> List[Optional[torch.Tensor]]:
    """Random f32 weights with the reference's shapes and scales (unit
    normal over sqrt(fan-in)), drawn from ``generator`` on its own device
    and placed on ``device``.  The values differ from the JAX package's;
    use :func:`weights_from_numpy` to run both on the same weights."""
    ws: List[Optional[torch.Tensor]] = []
    for l in graph.layers:
        spec = _weight_shape(l)
        if spec is None:
            ws.append(None)
            continue
        shape, fan_in = spec
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) / np.sqrt(fan_in)
        ws.append(w.to(device))
    return ws


def weights_from_numpy(graph: ModelGraph, arrays: Sequence,
                       device="cuda") -> List[Optional[torch.Tensor]]:
    """The port's weights from numpy arrays in the reference layout
    (``None`` for weightless layers), e.g. the JAX package's
    ``init_weights`` output through ``np.asarray``."""
    if len(arrays) != len(graph.layers):
        raise ValueError(f"{len(arrays)} weight arrays for "
                         f"{len(graph.layers)} layers")
    ws: List[Optional[torch.Tensor]] = []
    for l, a in zip(graph.layers, arrays):
        spec = _weight_shape(l)
        if spec is None:
            if a is not None:
                raise ValueError(f"{l.name} ({l.conv_t.name}) has no weight")
            ws.append(None)
            continue
        a = np.asarray(a, np.float32)
        if a.shape != spec[0]:
            raise ValueError(f"{l.name}: weight shape {a.shape} != "
                             f"{spec[0]}")
        ws.append(torch.from_numpy(a.copy()).to(device))
    return ws


def apply_layer(l: LayerSpec, w, x: torch.Tensor) -> torch.Tensor:
    """Full-tensor layer application. x: [H, W, C] (FC: [seq, 1, C])."""
    return _conv_region_p(l.conv_t, l.k, l.s, w, x,
                          pads=((l.p, l.p), (l.p, l.p)))


def _conv_region_p(conv_t: ConvT, k: int, s: int, w, x: torch.Tensor,
                   pads) -> torch.Tensor:
    """Generic ATen lowering of one layer over a region with explicit
    per-side pads ``((top, bottom), (left, right))``.  ``F.conv2d`` takes
    only symmetric padding, so pads go through ``F.pad`` first; POOL is a
    max reduce-window whose padding is -inf (the layer named ``avgpool``
    included).  Returns a channel-last ``[H, W, C]`` tensor with channel
    stride 1, the layout the shard kernels read."""
    (pt, pb), (pl_, pr) = pads
    if conv_t in (ConvT.CONV, ConvT.POINTWISE, ConvT.DWCONV, ConvT.POOL):
        h, wd, c = x.shape
        oh = (h + pt + pb - k) // s + 1
        ow = (wd + pl_ + pr - k) // s + 1
        cout = w.shape[3] if conv_t in (ConvT.CONV, ConvT.POINTWISE) else c
        if oh <= 0 or ow <= 0 or cout == 0:
            # empty shard cell (more nodes than output rows/cols)
            return x.new_zeros((max(oh, 0), max(ow, 0), cout))
        xn = x.permute(2, 0, 1)[None]
        if conv_t == ConvT.POOL:
            if pt or pb or pl_ or pr:
                xn = F.pad(xn, (pl_, pr, pt, pb), value=-float("inf"))
            out = F.max_pool2d(xn, k, s)
        else:
            if pt or pb or pl_ or pr:
                xn = F.pad(xn, (pl_, pr, pt, pb))
            out = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=s,
                           groups=c if conv_t == ConvT.DWCONV else 1)
        return out[0].permute(1, 2, 0).contiguous()
    if conv_t == ConvT.FC:
        return (x.reshape(x.shape[0], x.shape[-1]) @ w).reshape(
            x.shape[0], 1, -1)
    if conv_t in (ConvT.ADD, ConvT.CONCAT):
        return x   # single-input (chain-compat) merge is the identity
    raise ValueError(conv_t)


def merge_tensors(l: LayerSpec,
                  inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Combine the producer tensors of a multi-input merge layer."""
    if len(inputs) == 1:
        return inputs[0]
    if l.conv_t == ConvT.ADD:
        out = inputs[0]
        for t in inputs[1:]:
            out = out + t
        return out
    if l.conv_t == ConvT.CONCAT:
        return torch.cat(list(inputs), dim=-1)
    raise ValueError(f"{l.name}: only ADD/CONCAT layers can merge")


def run_reference(graph: ModelGraph, weights,
                  x: torch.Tensor) -> torch.Tensor:
    """Unpartitioned inference through the generic ATen path."""
    if graph.is_chain:
        for l, w in zip(graph.layers, weights):
            x = apply_layer(l, w, x)
        return x
    outs: Dict[int, torch.Tensor] = {-1: x}
    for i, (l, w) in enumerate(zip(graph.layers, weights)):
        prods = graph.producer_ids[i]
        if len(prods) >= 2:
            outs[i] = merge_tensors(l, [outs[p] for p in prods])
        else:
            outs[i] = apply_layer(l, w, outs[prods[0]])
    return outs[len(graph) - 1]


# ---------------------------------------------------------------------------
# Shard geometry
# ---------------------------------------------------------------------------

def _ranges(total: int, parts: int) -> List[Tuple[int, int]]:
    sizes = split_sizes(total, parts)
    out, a = [], 0
    for s in sizes:
        out.append((a, a + s))
        a += s
    return out


def exact_regions(l: LayerSpec, scheme: Scheme,
                  nodes: int) -> List[List[Rect]]:
    """Per-node exact (halo-free) output cells of layer ``l``.  One cell per
    node for the 1-D schemes; round-robin cell assignment for 2D-grid on
    non-square node counts (the paper's 3-node imbalance case)."""
    oh, ow, oc = l.out_h, l.out_w, l.out_c
    if scheme == Scheme.INH:
        return [[((r0, r1), (0, ow), (0, oc))]
                for r0, r1 in _ranges(oh, nodes)]
    if scheme == Scheme.INW:
        return [[((0, oh), (c0, c1), (0, oc))]
                for c0, c1 in _ranges(ow, nodes)]
    if scheme == Scheme.OUTC:
        return [[((0, oh), (0, ow), (k0, k1))]
                for k0, k1 in _ranges(oc, nodes)]
    if scheme == Scheme.GRID2D:
        gh, gw = grid_dims(nodes)
        cells = [((r0, r1), (c0, c1), (0, oc))
                 for r0, r1 in _ranges(oh, gh) for c0, c1 in _ranges(ow, gw)]
        per_node: List[List[Rect]] = [[] for _ in range(nodes)]
        for i, cell in enumerate(cells):
            per_node[i % nodes].append(cell)
        return per_node
    raise ValueError(scheme)


def in_rows(l: LayerSpec, out_r: Tuple[int, int], dim: int
            ) -> Tuple[int, int]:
    """Unclipped input range needed for an output range along H (dim=0,
    bound l.in_h) or W (dim=1, bound l.in_w).  FC/ADD/CONCAT are 1:1."""
    if l.conv_t in (ConvT.FC, ConvT.ADD, ConvT.CONCAT):
        return out_r
    r0 = out_r[0] * l.s - l.p
    r1 = (out_r[1] - 1) * l.s - l.p + l.k
    return (r0, r1)


def _clip(r: Tuple[int, int], bound: int) -> Tuple[int, int]:
    return (max(0, r[0]), min(bound, r[1]))


# ---------------------------------------------------------------------------
# Plan execution
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StageTime:
    """Measured wall time of one dispatched pipeline stage (mesh executor,
    ``instrument=True``).  ``device_done_s[n]`` is node ``n``'s completion
    offset from the stage's start: on the card CUDA events on the node's
    stream against an event recorded before the fork, both inside the
    stage's captured graph once it replays; on the CPU the host clock
    after the node's branch (the nodes run one after another)."""

    kind: str                            # "compute" | "sync"
    label: str                           # simulator stage label convention
    wall_s: float
    device_done_s: Tuple[float, ...] = ()


@dataclasses.dataclass(frozen=True)
class MeasuredOccupancy:
    """Per-request resource-class occupancy measured from a real run —
    the counterpart of the simulator occupancy that the reference's
    ``cluster.refine`` extracts from a ``SimReport``
    (``occupancy_fn`` protocol)."""

    dev_occupancy_s: float     # max over nodes of summed compute time
    link_occupancy_s: float    # summed sync-stage wall time
    period_s: float            # pipelined steady-state period estimate
    latency_s: float           # single-request wall time
    #: dispatch failures behind the measurement (retries + timeouts +
    #: degraded fallbacks) — ``cluster.refine`` treats any nonzero value
    #: as an untrusted sample and keeps its previous axis weights
    failures: int = 0


@dataclasses.dataclass
class ExecStats:
    sync_points: int = 0
    bytes_received: float = 0.0      # across all nodes/boundaries (fp32)
    redundant_elems: float = 0.0     # halo outputs computed more than once
    #: executed T-terminated segments — the plan's compute-stage count
    compute_stages: int = 0
    #: measured pipeline stages (mesh executor with ``instrument=True``).
    #: Excluded from equality: geometry accounting is executor- and
    #: backend-independent by contract, wall times never are.
    stage_times: List[StageTime] = dataclasses.field(
        default_factory=list, compare=False, repr=False)
    #: end-to-end wall seconds of the run (mesh executor only)
    wall_s: float = dataclasses.field(default=0.0, compare=False)
    #: stage dispatches re-attempted after a failure (mesh executor with
    #: ``stage_retries > 0``), excluded from equality like wall times
    retries: int = dataclasses.field(default=0, compare=False)
    #: stage dispatches that exceeded ``stage_timeout_s``
    timeouts: int = dataclasses.field(default=0, compare=False)
    #: runs completed by the degraded single-process fallback
    fallbacks: int = dataclasses.field(default=0, compare=False)

    @property
    def failure_count(self) -> int:
        """Total faults observed while producing this run's numbers."""
        return self.retries + self.timeouts + self.fallbacks

    def to_occupancy(self) -> MeasuredOccupancy:
        """Fold the measured stage times into per-resource-class occupancy:
        device occupancy is the straggler node's summed compute time, link
        occupancy sums the sync-stage walls, and the period is the busier
        class (the reference's ``PipelineCost`` bottleneck semantics
        applied to measurements)."""
        if not self.stage_times:
            raise ValueError(
                "no measured stages — run with "
                'ExecConfig(executor="mesh", instrument=True) '
                "(only the mesh executor measures stage times)")
        per_dev: Dict[int, float] = {}
        sync = 0.0
        for st in self.stage_times:
            if st.kind == "compute":
                if st.device_done_s:
                    for d, t in enumerate(st.device_done_s):
                        per_dev[d] = per_dev.get(d, 0.0) + t
                else:
                    per_dev[0] = per_dev.get(0, 0.0) + st.wall_s
            else:
                sync += st.wall_s
        dev = max(per_dev.values()) if per_dev else 0.0
        return MeasuredOccupancy(
            dev_occupancy_s=dev, link_occupancy_s=sync,
            period_s=max(dev, sync), latency_s=self.wall_s,
            failures=self.failure_count)


def _rect_elems(r: Rect) -> int:
    return max(0, r[0][1] - r[0][0]) * max(0, r[1][1] - r[1][0]) \
        * max(0, r[2][1] - r[2][0])


def _rect_isect(a: Rect, b: Rect) -> Rect:
    return tuple((max(x[0], y[0]), min(x[1], y[1]))
                 for x, y in zip(a, b))  # type: ignore[return-value]


def backward_chain(layers: Sequence[LayerSpec], a: int, b: int,
                   reg_b: Rect) -> Tuple[Dict[int, Rect], Rect]:
    """Backward-chain the receptive field of output region ``reg_b`` of
    layer ``b`` through segment ``[a..b]``: the per-layer needed output
    regions (clipped to each layer's bounds) and the clipped input rect at
    the segment entry."""
    need: Dict[int, Rect] = {b: reg_b}
    rows, cols = reg_b[0], reg_b[1]
    for li in range(b, a, -1):
        rows = _clip(in_rows(layers[li], rows, 0), layers[li].in_h)
        cols = _clip(in_rows(layers[li], cols, 1), layers[li].in_w)
        need[li - 1] = (rows, cols, (0, layers[li - 1].out_c))
    l_in = layers[a]
    in_r = _clip(in_rows(l_in, need[a][0], 0), l_in.in_h)
    in_c = _clip(in_rows(l_in, need[a][1], 1), l_in.in_w)
    return need, (in_r, in_c, (0, l_in.in_c))


#: per-layer static record: (conv_t, k, s, pads(pt,pb,pl,pr) | None,
#: slices(r0,r1,c0,c1) | None, chans(c0,c1))
_SegRec = Tuple[int, int, int, Optional[Tuple[int, int, int, int]],
                Optional[Tuple[int, int, int, int]], Tuple[int, int]]


def _segment_records(layers: Sequence[LayerSpec], a: int, b: int,
                     need: Dict[int, Rect],
                     in_rect: Rect) -> Tuple[_SegRec, ...]:
    """Resolve the cell's per-layer slice/pad arithmetic into static
    records (the full program spec of one segment cell)."""
    recs: List[_SegRec] = []
    origin = (in_rect[0][0], in_rect[1][0])
    extent = (in_rect[0][1] - in_rect[0][0], in_rect[1][1] - in_rect[1][0])
    for li in range(a, b + 1):
        l = layers[li]
        rows, cols, chans = need[li]
        if l.conv_t in (ConvT.FC, ConvT.ADD, ConvT.CONCAT):
            recs.append((int(l.conv_t), l.k, l.s, None, None, chans))
        else:
            nr = in_rows(l, rows, 0)
            nc = in_rows(l, cols, 1)
            pads = (max(0, -nr[0]), max(0, nr[1] - l.in_h),
                    max(0, -nc[0]), max(0, nc[1] - l.in_w))
            sl = (max(0, nr[0]) - origin[0], min(l.in_h, nr[1]) - origin[0],
                  max(0, nc[0]) - origin[1], min(l.in_w, nc[1]) - origin[1])
            assert sl[0] >= 0 and sl[2] >= 0 \
                and sl[1] <= extent[0] and sl[3] <= extent[1], (
                    "local slice does not cover the needed region", l.name)
            recs.append((int(l.conv_t), l.k, l.s, pads, sl, chans))
        origin = (rows[0], cols[0])
        extent = (rows[1] - rows[0], cols[1] - cols[0])
    return tuple(recs)


def _apply_record(rec: _SegRec, w, x: torch.Tensor) -> torch.Tensor:
    """One layer of a segment program on the generic ATen path."""
    conv_t, k, s, pads, sl, chans = rec
    conv_t = ConvT(conv_t)
    if conv_t == ConvT.FC:
        seg = x.reshape(x.shape[0], x.shape[-1])
        return (seg @ w[:, chans[0]:chans[1]]).reshape(
            x.shape[0], 1, chans[1] - chans[0])
    if conv_t in (ConvT.ADD, ConvT.CONCAT):
        return x[:, :, chans[0]:chans[1]]
    pt, pb, pl_, pr = pads
    r0, r1, c0, c1 = sl
    xs = x[r0:r1, c0:c1, :]
    if conv_t in (ConvT.CONV, ConvT.POINTWISE):
        wsel = w[:, :, :, chans[0]:chans[1]]
        return _conv_region_p(conv_t, k, s, wsel, xs, ((pt, pb), (pl_, pr)))
    out = _conv_region_p(conv_t, k, s, w, xs, ((pt, pb), (pl_, pr)))
    return out[:, :, chans[0]:chans[1]]


def _apply_record_cuda(rec: _SegRec, w, x: torch.Tensor) -> torch.Tensor:
    """Kernel lowering of one segment-layer record: the local slice (halo
    rows included) goes to the shard kernel as a strided view with its
    per-side zero pads, and an OutC shard's weight as a channel view.
    Raises :class:`UnsupportedGeometry` for records the kernels cannot
    lower (POOL, degenerate shard outputs) — the caller falls back to the
    generic record path."""
    conv_t, k, s, pads, sl, chans = rec
    conv_t = ConvT(conv_t)
    if conv_t == ConvT.FC:
        seg = x.reshape(x.shape[0], x.shape[-1])
        out = matmul_tiled(seg, w[:, chans[0]:chans[1]])
        return out.reshape(x.shape[0], 1, chans[1] - chans[0])
    if conv_t in (ConvT.ADD, ConvT.CONCAT):
        return x[:, :, chans[0]:chans[1]]
    if conv_t not in (ConvT.CONV, ConvT.POINTWISE, ConvT.DWCONV):
        raise UnsupportedGeometry(f"no shard kernel for {conv_t.name}")
    r0, r1, c0, c1 = sl
    xs = x[r0:r1, c0:c1, :]
    if conv_t == ConvT.DWCONV:
        out = conv2d_shard(xs, w, pads=pads, stride=s, depthwise=True)
        return out[:, :, chans[0]:chans[1]]
    return conv2d_shard(xs, w[:, :, :, chans[0]:chans[1]], pads=pads,
                        stride=s)


def _apply_record_b(rec: _SegRec, w, x: torch.Tensor,
                    backend: str) -> torch.Tensor:
    """Backend dispatch for one record, with the per-record fallback to
    the generic path on unsupported geometry (and only on that: device,
    dtype, build and launch faults propagate)."""
    if backend == "cuda":
        try:
            return _apply_record_cuda(rec, w, x)
        except UnsupportedGeometry:
            pass
    return _apply_record(rec, w, x)


def _run_records(recs: Sequence[_SegRec], weights: Sequence,
                 x: torch.Tensor, backend: str) -> torch.Tensor:
    """One segment cell's records, eagerly, one after another."""
    for rec, w in zip(recs, weights):
        x = _apply_record_b(rec, w, x, backend)
    return x


class _SegmentProgram:
    """One cached segment program: a cell's records, run eagerly on CPU
    tensors and as a captured graph on the card, where it holds the
    weights whose pointers the graph bakes in."""

    def __init__(self, recs: Tuple[_SegRec, ...], backend: str,
                 weights: Sequence, x: torch.Tensor):
        self.recs = recs
        self.backend = backend
        self.graph = None
        if x.is_cuda:
            ws = tuple(weights)
            self.graph = GraphProgram(
                lambda a: _run_records(recs, ws, a, backend),
                torch.empty(x.shape, dtype=x.dtype, device=x.device))

    def __call__(self, x: torch.Tensor, weights: Sequence) -> torch.Tensor:
        """The cell's output; on the card it lies in the graph's memory
        and the program's next call overwrites it."""
        if self.graph is None:
            return _run_records(self.recs, weights, x, self.backend)
        return self.graph(x)


SegmentCacheInfo = collections.namedtuple(
    "SegmentCacheInfo", ["hits", "misses", "maxsize", "currsize"])
_SEGMENTS: Dict[tuple, _SegmentProgram] = {}
_SEGMENT_STATS = {"hits": 0, "misses": 0}


def _weight_key(w) -> Optional[tuple]:
    if w is None:
        return None
    return (w.data_ptr(), tuple(w.shape), w.stride(), w.dtype)


def _compiled_segment(recs: Tuple[_SegRec, ...], backend: str,
                      weights: Sequence, x: torch.Tensor) -> _SegmentProgram:
    """The program of one (segment-cell signature, backend) pair for these
    weights and this input geometry, from the cache or made and cached."""
    key = (recs, backend, tuple(_weight_key(w) for w in weights),
           tuple(x.shape), x.dtype, x.device)
    prog = _SEGMENTS.get(key)
    if prog is None:
        _SEGMENT_STATS["misses"] += 1
        prog = _SEGMENTS[key] = _SegmentProgram(recs, backend, weights, x)
    else:
        _SEGMENT_STATS["hits"] += 1
    return prog


def segment_cache_info() -> SegmentCacheInfo:
    """(hits, misses, maxsize, currsize) of the segment-program cache —
    repeated cells and repeated ``Session.run`` calls should mostly hit.
    ``maxsize`` is None: the cache is unbounded."""
    return SegmentCacheInfo(_SEGMENT_STATS["hits"],
                            _SEGMENT_STATS["misses"], None, len(_SEGMENTS))


def clear_segment_cache() -> None:
    """Drop every segment program (and its graph and memory) and zero the
    counts."""
    _SEGMENTS.clear()
    _SEGMENT_STATS.update(hits=0, misses=0)


def _run_branch(layers: Sequence[LayerSpec],
                weights: Sequence,
                steps: Sequence[Tuple[Scheme, Mode]],
                x: torch.Tensor,
                owned: Optional[List[List[Rect]]],
                nodes: int,
                stats: ExecStats,
                jit_segments: bool = True,
                backend: str = "cuda"
                ) -> Tuple[torch.Tensor, List[List[Rect]]]:
    """Execute one chain of layers segment by segment.  ``x`` is the full
    input tensor at the branch entry; ``owned`` is the per-node layout it is
    distributed in (None = initial input, no comm accounting).  Returns the
    full output and its per-node layout at the final T boundary."""
    full = x
    for (a, b) in steps_segments(steps):
        scheme = steps[a][0]
        regs_b = exact_regions(layers[b], scheme, nodes)
        # T boundary: each cell's shard is reassembled ("synchronized")
        # into this buffer as soon as it is computed
        lb = layers[b]
        rebuilt = torch.zeros((lb.out_h, lb.out_w, lb.out_c),
                              dtype=full.dtype, device=full.device)
        computed = 0
        for n, cells in enumerate(regs_b):
            for reg_b in cells:
                # backward-chain the needed region through the segment
                need, in_rect = backward_chain(layers, a, b, reg_b)
                (in_r, in_c, _) = in_rect
                # communication accounting: elems this node did not hold
                if owned is not None:
                    held = sum(_rect_elems(_rect_isect(in_rect, o))
                               for o in owned[n])
                    stats.bytes_received += DTYPE_BYTES * (
                        _rect_elems(in_rect) - held)
                node_x = full[in_r[0]:in_r[1], in_c[0]:in_c[1], :]
                for li in range(a, b):
                    computed += _rect_elems(need[li])
                recs = _segment_records(layers, a, b, need, in_rect)
                ws = weights[a:b + 1]
                if jit_segments:
                    node_x = _compiled_segment(recs, backend, ws,
                                               node_x)(node_x, ws)
                else:
                    node_x = _run_records(recs, ws, node_x, backend)
                (r, c, ch) = reg_b
                rebuilt[r[0]:r[1], c[0]:c[1], ch[0]:ch[1]] = node_x
        stats.sync_points += 1
        stats.redundant_elems += float(computed)
        stats.compute_stages += 1
        owned = regs_b
        full = rebuilt
    assert owned is not None, "branch must contain at least one segment"
    return full, owned


def _merge_comm_bytes(l: LayerSpec, prods: Sequence[int],
                      prod_channels: Sequence[int],
                      owned_map: Dict[int, Optional[List[List[Rect]]]],
                      regs: List[List[Rect]]) -> float:
    """Bytes every node must receive to assemble its merge-output regions
    from the producers' shard layouts.  CONCAT maps output-channel windows
    back into each producer's channel range (``prod_channels`` includes the
    graph input's channels, keeping later windows aligned); ADD needs the
    same region of every input."""
    offsets: List[int] = []
    off = 0
    for c in prod_channels:
        offsets.append(off)
        off += c if l.conv_t == ConvT.CONCAT else 0
    total = 0.0
    for n, cells in enumerate(regs):
        for (rows, cols, chans) in cells:
            for j, pid in enumerate(prods):
                if l.conv_t == ConvT.CONCAT:
                    c0 = max(chans[0] - offsets[j], 0)
                    c1 = min(chans[1] - offsets[j], prod_channels[j])
                    if c1 <= c0:
                        continue
                    need: Rect = (rows, cols, (c0, c1))
                else:
                    need = (rows, cols, chans)
                owned = owned_map.get(pid)
                if owned is None:
                    continue   # graph input: pre-distributed, not counted
                held = sum(_rect_elems(_rect_isect(need, o))
                           for o in owned[n])
                total += DTYPE_BYTES * (_rect_elems(need) - held)
    return total


def _run_partitioned_local(graph: ModelGraph, weights, x: torch.Tensor,
                           plan: Plan, nodes: int,
                           jit_segments: bool = True,
                           backend: str = "cuda"
                           ) -> Tuple[torch.Tensor, ExecStats]:
    """Execute ``plan`` on ``nodes`` simulated devices in-process (the
    ``executor="local"`` path behind :class:`~repro_torch.runtime.session.
    Session`).  ``backend`` selects the segment-layer lowering: ``"torch"``
    (generic ATen) or ``"cuda"`` (shard kernels with per-record generic
    fallback); ``jit_segments`` routes every segment cell through the
    segment-program cache.  Stats accounting is backend- and
    program-independent by construction."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    stats = ExecStats()
    if graph.is_chain:
        plan.validate()
        if len(plan) != len(graph):
            raise ValueError("plan/graph length mismatch")
        full, _ = _run_branch(graph.layers, weights, plan.steps, x, None,
                              nodes, stats, jit_segments, backend)
        return full, stats

    plan.validate_for(graph)
    layers = graph.layers
    outs: Dict[int, torch.Tensor] = {-1: x}
    owned_map: Dict[int, Optional[List[List[Rect]]]] = {-1: None}
    for br in graph.linearize():
        ids = list(br.ids)
        head = ids[0]
        prods = graph.producer_ids[head]
        if len(prods) >= 2:
            l_m = layers[head]
            q = plan.steps[head][0]
            merged = merge_tensors(l_m, [outs[p] for p in prods])
            regs = exact_regions(l_m, q, nodes)
            stats.sync_points += 1
            # the merge layer's T-singleton segment executes inside
            # merge_tensors — still one compute stage of the pipeline
            stats.compute_stages += 1
            stats.bytes_received += _merge_comm_bytes(
                l_m, prods,
                [layers[p].out_c if p >= 0 else layers[0].in_c
                 for p in prods],
                owned_map, regs)
            cur, owned = merged, regs
            rest = ids[1:]
        else:
            src = prods[0]
            cur, owned = outs[src], owned_map[src]
            rest = ids
        if rest:
            ls = [layers[i] for i in rest]
            ws = [weights[i] for i in rest]
            st = [plan.steps[i] for i in rest]
            cur, owned = _run_branch(ls, ws, st, cur, owned, nodes, stats,
                                     jit_segments, backend)
        outs[ids[-1]] = cur
        owned_map[ids[-1]] = owned
    return outs[len(graph) - 1], stats
