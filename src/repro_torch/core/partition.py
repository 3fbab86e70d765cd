"""Partition-scheme geometry: shard sizes, halos, balance, comm volumes.

Implements the four schemes of Fig. 1 — One-dim InH / InW / OutC and 2D-grid —
plus the T/NT boundary semantics of §2.3.  Everything here is exact integer
geometry (no estimation); the cost model in ``cost.py`` turns these byte/FLOP
counts into times for a given testbed.

The scalar helpers each have a ``*_batch`` ufunc form operating on stacked
feature columns (one row per query).  The batch forms replicate the scalar
float operation *order*, so results are bit-identical — the planner's
batched cost tables must agree exactly with the scalar reference path.

A copy of the JAX package's ``core/partition.py``, with its
capability-weighted (heterogeneous-cluster) forms.  The enum values are the
reference's, so plans convert between the packages by value.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import List, Sequence, Tuple

import numpy as np

from .graph import ConvT, LayerSpec


class Scheme(enum.IntEnum):
    INH = 0      # split input/output feature-map height
    INW = 1      # split width
    OUTC = 2     # split output channels
    GRID2D = 3   # split height x width grid

    @property
    def spatial(self) -> bool:
        return self in (Scheme.INH, Scheme.INW, Scheme.GRID2D)


class Mode(enum.IntEnum):
    T = 0    # transmit boundary/re-layout data after this layer
    NT = 1   # no transmission; fuse via redundant halo compute


ALL_SCHEMES: Tuple[Scheme, ...] = (Scheme.INH, Scheme.INW, Scheme.OUTC,
                                   Scheme.GRID2D)


def split_sizes(total: int, parts: int) -> List[int]:
    """Balanced 1-D split (ceil for the first ``total % parts`` shards)."""
    q, r = divmod(total, parts)
    return [q + (1 if i < r else 0) for i in range(parts)]


def weighted_split_sizes(total: int, weights: Sequence[float]) -> List[int]:
    """Capability-proportional integer split (largest-remainder method).

    Device ``d`` receives ``round(total * w_d / sum(w))`` units, with the
    leftover units after flooring handed to the largest fractional parts
    (ties broken toward lower device index).  Uniform weights reduce
    *exactly* to :func:`split_sizes` — every fractional part ties, so the
    first ``total % parts`` shards take the ceil, shard for shard — which
    is what keeps homogeneous ``ClusterSpec`` costs bit-identical to the
    historical ``Testbed`` path.  A zero weight yields a zero-size shard.
    """
    ws = [float(w) for w in weights]
    if any(w < 0.0 for w in ws):
        raise ValueError(f"negative capability weight in {ws}")
    s = sum(ws)
    if s <= 0.0:
        raise ValueError("capability weights must sum to a positive value")
    ideal = [total * w / s for w in ws]
    base = [int(math.floor(x)) for x in ideal]
    rem = total - sum(base)
    order = sorted(range(len(ws)), key=lambda i: (base[i] - ideal[i], i))
    for i in order[:rem]:
        base[i] += 1
    return base


def grid_dims(nodes: int) -> Tuple[int, int]:
    """2D-grid cell layout.  4 nodes -> 2x2.  Non-square node counts get a
    ceil(sqrt) grid whose cells are assigned round-robin, reproducing the
    paper's observation that 3 nodes leave one node with 2x the work."""
    gh = int(math.ceil(math.sqrt(nodes)))
    gw = int(math.ceil(nodes / gh))
    return gh, gw


@dataclasses.dataclass(frozen=True)
class ShardWork:
    """Per-node workload of one layer under one scheme."""

    flops_per_node: Tuple[float, ...]   # straggler = max(...)
    out_bytes_per_node: Tuple[float, ...]

    @property
    def straggler_flops(self) -> float:
        return max(self.flops_per_node)


DTYPE_BYTES = 4.0  # fp32 feature maps (TMS320C6678 is a float DSP)


def _conv_row_flops(layer: LayerSpec, out_rows: int, out_cols: int,
                    out_ch: int) -> float:
    """FLOPs to produce an ``out_rows x out_cols x out_ch`` output region."""
    if layer.conv_t in (ConvT.CONV, ConvT.POINTWISE):
        per = 2.0 * layer.in_c * layer.k * layer.k
    elif layer.conv_t == ConvT.DWCONV:
        per = 2.0 * layer.k * layer.k
    elif layer.conv_t == ConvT.POOL:
        per = 1.0 * layer.k * layer.k
    elif layer.conv_t == ConvT.FC:
        # FC: "rows" = sequence positions, cols = 1
        per = 2.0 * layer.in_c
    elif layer.conv_t in (ConvT.ATTN, ConvT.FFN):
        # projection MACs; score/AV (ATTN) and hidden (FFN) work is linear
        # in the owned output region and rides in extra_flop_factor
        per = 2.0 * layer.in_c
    elif layer.conv_t == ConvT.ADD:
        per = float(max(1, layer.fan_in - 1))   # (fan_in - 1) adds per elem
    else:  # CONCAT: copy cost
        per = 1.0
    return per * out_rows * out_cols * out_ch * layer.extra_flop_factor


def shard_work(layer: LayerSpec, scheme: Scheme, nodes: int,
               extra_halo: int = 0) -> ShardWork:
    """Workload of ``layer`` under ``scheme`` on ``nodes`` devices.

    ``extra_halo`` = extra output rows (per side) this layer must additionally
    compute because later layers are NT-fused after it (see
    ``graph.halo_growth``).  Only spatial schemes accept a nonzero halo; OutC
    cannot run in NT mode (its next layer needs the full input).
    """
    oh, ow, oc = layer.out_h, layer.out_w, layer.out_c
    if extra_halo and not scheme.spatial:
        raise ValueError("NT halo is undefined for OutC partition")

    flops: List[float] = []
    obytes: List[float] = []
    if scheme == Scheme.INH:
        for rows in split_sizes(oh, nodes):
            r = min(rows + 2 * extra_halo, oh)
            flops.append(_conv_row_flops(layer, r, ow, oc))
            obytes.append(r * ow * oc * DTYPE_BYTES)
    elif scheme == Scheme.INW:
        for cols in split_sizes(ow, nodes):
            c = min(cols + 2 * extra_halo, ow)
            flops.append(_conv_row_flops(layer, oh, c, oc))
            obytes.append(oh * c * oc * DTYPE_BYTES)
    elif scheme == Scheme.OUTC:
        if layer.heads:
            # ATTN: shard at head granularity (a head's channels never split)
            per_head = oc // layer.heads
            chs = [h * per_head for h in split_sizes(layer.heads, nodes)]
        else:
            chs = split_sizes(oc, nodes)
        for ch in chs:
            flops.append(_conv_row_flops(layer, oh, ow, ch))
            obytes.append(oh * ow * ch * DTYPE_BYTES)
    elif scheme == Scheme.GRID2D:
        gh, gw = grid_dims(nodes)
        rsz, csz = split_sizes(oh, gh), split_sizes(ow, gw)
        cells = [(r, c) for r in rsz for c in csz]
        per_node_f = [0.0] * nodes
        per_node_b = [0.0] * nodes
        for idx, (r, c) in enumerate(cells):
            node = idx % nodes
            rr = min(r + 2 * extra_halo, oh)
            cc = min(c + 2 * extra_halo, ow)
            per_node_f[node] += _conv_row_flops(layer, rr, cc, oc)
            per_node_b[node] += rr * cc * oc * DTYPE_BYTES
        flops, obytes = per_node_f, per_node_b
    else:  # pragma: no cover
        raise ValueError(scheme)
    return ShardWork(tuple(flops), tuple(obytes))


def hetero_shard_work(layer: LayerSpec, scheme: Scheme,
                      weights: Sequence[float],
                      extra_halo: int = 0) -> ShardWork:
    """Workload of ``layer`` under ``scheme`` with capability-weighted shard
    fractions: device ``d`` owns a :func:`weighted_split_sizes` share of the
    split axis instead of a balanced one.

    Mirrors :func:`shard_work` expression for expression (including the
    ``min(extent + 2*halo, full)`` NT-halo clip), so uniform weights give
    bit-identical per-node numbers.  GRID2D keeps the balanced round-robin
    cell grid — the 2-D cell layout has no natural 1-D weighting — so
    capability only enters GRID2D through the per-device *speeds* the cost
    model divides by (skewed clusters simply stop choosing it).
    """
    nodes = len(weights)
    oh, ow, oc = layer.out_h, layer.out_w, layer.out_c
    if extra_halo and not scheme.spatial:
        raise ValueError("NT halo is undefined for OutC partition")
    if scheme == Scheme.GRID2D:
        return shard_work(layer, scheme, nodes, extra_halo=extra_halo)

    flops: List[float] = []
    obytes: List[float] = []
    if scheme == Scheme.INH:
        for rows in weighted_split_sizes(oh, weights):
            r = min(rows + 2 * extra_halo, oh)
            flops.append(_conv_row_flops(layer, r, ow, oc))
            obytes.append(r * ow * oc * DTYPE_BYTES)
    elif scheme == Scheme.INW:
        for cols in weighted_split_sizes(ow, weights):
            c = min(cols + 2 * extra_halo, ow)
            flops.append(_conv_row_flops(layer, oh, c, oc))
            obytes.append(oh * c * oc * DTYPE_BYTES)
    elif scheme == Scheme.OUTC:
        if layer.heads:
            per_head = oc // layer.heads
            chs = [h * per_head
                   for h in weighted_split_sizes(layer.heads, weights)]
        else:
            chs = weighted_split_sizes(oc, weights)
        for ch in chs:
            flops.append(_conv_row_flops(layer, oh, ow, ch))
            obytes.append(oh * ow * ch * DTYPE_BYTES)
    else:  # pragma: no cover
        raise ValueError(scheme)
    return ShardWork(tuple(flops), tuple(obytes))


def min_shard_extent(layer: LayerSpec, scheme: Scheme, nodes: int) -> int:
    """Smallest spatial extent any node owns under ``scheme`` — the bound at
    which an NT halo degenerates into full replication."""
    if scheme == Scheme.INH:
        return min(split_sizes(layer.out_h, nodes))
    if scheme == Scheme.INW:
        return min(split_sizes(layer.out_w, nodes))
    if scheme == Scheme.GRID2D:
        gh, gw = grid_dims(nodes)
        return min(min(split_sizes(layer.out_h, gh)),
                   min(split_sizes(layer.out_w, gw)))
    return 1


# ---------------------------------------------------------------------------
# Communication volumes (bytes) for T-mode boundaries.
# ---------------------------------------------------------------------------

def boundary_bytes_same_scheme(layer: LayerSpec, nxt: LayerSpec,
                               scheme: Scheme, nodes: int) -> float:
    """T-mode halo exchange when this layer and the next share a spatial
    scheme: each interior boundary moves (K_next - 1) rows/cols of the output
    feature map, both directions.  Returns the *per-busiest-node* byte count
    (what the latency-dominant node sends+receives)."""
    halo = max(nxt.k - 1, 0)
    if halo == 0 or nodes <= 1:
        return 0.0   # K=1 (FC/ADD/CONCAT/pointwise) or a single node: no halo
    oh, ow, oc = layer.out_h, layer.out_w, layer.out_c
    if scheme == Scheme.INH:
        return 2.0 * halo * ow * oc * DTYPE_BYTES        # two neighbours
    if scheme == Scheme.INW:
        return 2.0 * halo * oh * oc * DTYPE_BYTES
    if scheme == Scheme.GRID2D:
        gh, gw = grid_dims(nodes)
        rows = math.ceil(oh / gh)
        cols = math.ceil(ow / gw)
        # up/down + left/right + corners
        return 2.0 * halo * (cols + rows + halo) * oc * DTYPE_BYTES
    raise ValueError(scheme)


# ---------------------------------------------------------------------------
# Batched (ufunc) forms.  One row per query; integer columns are int64
# arrays, float columns float64.  Float expressions copy the scalar
# operation order verbatim so results are bit-identical to the scalar path.
# ---------------------------------------------------------------------------

def ceil_div_batch(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise ``ceil(a / b)`` on integer arrays."""
    return -(-a // b)


def grid_dims_batch(nodes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vector form of :func:`grid_dims`."""
    gh = np.ceil(np.sqrt(nodes)).astype(np.int64)
    gw = np.ceil(nodes / gh).astype(np.int64)
    return gh, gw


def conv_flops_per_elem_batch(conv_t: np.ndarray, in_c: np.ndarray,
                              k: np.ndarray,
                              fan_in: np.ndarray) -> np.ndarray:
    """Vector form of the per-output-element FLOP factor of
    :func:`_conv_row_flops` (everything except the output region size)."""
    return np.select(
        [(conv_t == ConvT.CONV) | (conv_t == ConvT.POINTWISE),
         conv_t == ConvT.DWCONV,
         conv_t == ConvT.POOL,
         (conv_t == ConvT.FC) | (conv_t == ConvT.ATTN)
         | (conv_t == ConvT.FFN),
         conv_t == ConvT.ADD],
        [2.0 * in_c * k * k,
         2.0 * k * k,
         1.0 * k * k,
         2.0 * in_c,
         np.maximum(1, fan_in - 1) * 1.0],
        default=1.0)  # CONCAT: copy cost


def straggler_flops_batch(per_elem: np.ndarray, oh: np.ndarray,
                          ow: np.ndarray, oc: np.ndarray,
                          scheme: np.ndarray, nodes: np.ndarray,
                          halo: np.ndarray,
                          flop_factor: np.ndarray,
                          heads: np.ndarray = None) -> np.ndarray:
    """Vector form of ``shard_work(...).straggler_flops``.

    The 1-D schemes reduce to the ceil-shard in closed form (workload is
    monotone in shard extent, so the straggler is the first shard of the
    balanced split).  GRID2D replays the round-robin cell assignment per
    distinct node count, accumulating cells in the scalar order.  Rows with
    ``heads > 0`` (ATTN layers) split OutC at head granularity.
    """
    if np.any((halo > 0) & (scheme == Scheme.OUTC)):
        raise ValueError("NT halo is undefined for OutC partition")
    if heads is None:
        heads = np.zeros(per_elem.shape, np.int64)
    out = np.empty(per_elem.shape, np.float64)

    m = scheme == Scheme.INH
    if m.any():
        r = np.minimum(ceil_div_batch(oh[m], nodes[m]) + 2 * halo[m], oh[m])
        out[m] = per_elem[m] * r * ow[m] * oc[m] * flop_factor[m]
    m = scheme == Scheme.INW
    if m.any():
        c = np.minimum(ceil_div_batch(ow[m], nodes[m]) + 2 * halo[m], ow[m])
        out[m] = per_elem[m] * oh[m] * c * oc[m] * flop_factor[m]
    m = scheme == Scheme.OUTC
    if m.any():
        h = np.maximum(heads[m], 1)
        ch = np.where(heads[m] > 0,
                      ceil_div_batch(h, nodes[m]) * (oc[m] // h),
                      ceil_div_batch(oc[m], nodes[m]))
        out[m] = per_elem[m] * oh[m] * ow[m] * ch * flop_factor[m]
    gmask = scheme == Scheme.GRID2D
    for nval in np.unique(nodes[gmask]) if gmask.any() else ():
        m = gmask & (nodes == nval)
        gh, gw = grid_dims(int(nval))
        q_r, rem_r = oh[m] // gh, oh[m] % gh
        q_c, rem_c = ow[m] // gw, ow[m] % gw
        acc = np.zeros((int(nval), int(m.sum())), np.float64)
        for j in range(gh * gw):   # round-robin cells, scalar order
            r = q_r + (j // gw < rem_r)
            c = q_c + (j % gw < rem_c)
            rr = np.minimum(r + 2 * halo[m], oh[m])
            cc = np.minimum(c + 2 * halo[m], ow[m])
            acc[j % int(nval)] += \
                per_elem[m] * rr * cc * oc[m] * flop_factor[m]
        out[m] = acc.max(axis=0)
    return out


def weighted_split_batch(total: np.ndarray,
                         weights: np.ndarray) -> np.ndarray:
    """Vector form of :func:`weighted_split_sizes`: one shared weight vector,
    a batch of totals.  Returns an ``(n_rows, n_devices)`` int64 matrix,
    row-for-row identical to the scalar largest-remainder split."""
    total = np.asarray(total, np.int64)
    w = np.asarray(weights, np.float64)
    if np.any(w < 0.0):
        raise ValueError(f"negative capability weight in {w}")
    s = float(w.sum())
    if s <= 0.0:
        raise ValueError("capability weights must sum to a positive value")
    ideal = total[:, None] * w[None, :] / s
    base = np.floor(ideal).astype(np.int64)
    rem = total - base.sum(axis=1)
    order = np.argsort(base - ideal, axis=1, kind="stable")
    rank = np.empty_like(order)
    np.put_along_axis(rank, order,
                      np.broadcast_to(np.arange(len(w)), order.shape), axis=1)
    return base + (rank < rem[:, None])


def hetero_flops_batch(per_elem: np.ndarray, oh: np.ndarray, ow: np.ndarray,
                       oc: np.ndarray, scheme: np.ndarray, halo: np.ndarray,
                       flop_factor: np.ndarray,
                       weights: np.ndarray,
                       heads: np.ndarray = None) -> np.ndarray:
    """Vector form of ``hetero_shard_work(...).flops_per_node`` over stacked
    feature columns: returns the full ``(n_rows, n_devices)`` per-device
    FLOP matrix (the cost model divides by per-device speeds and takes the
    straggler max).  Expression order mirrors the scalar path so uniform
    weights stay bit-identical to :func:`straggler_flops_batch`.  Rows with
    ``heads > 0`` (ATTN layers) split OutC at head granularity."""
    if np.any((halo > 0) & (scheme == Scheme.OUTC)):
        raise ValueError("NT halo is undefined for OutC partition")
    if heads is None:
        heads = np.zeros(per_elem.shape, np.int64)
    ndev = len(weights)
    out = np.empty((len(per_elem), ndev), np.float64)

    def _oned(m: np.ndarray, extent: np.ndarray, clip_halo: bool) -> \
            np.ndarray:
        e = weighted_split_batch(extent[m], weights)
        if clip_halo:
            e = np.minimum(e + 2 * halo[m][:, None], extent[m][:, None])
        return e

    m = scheme == Scheme.INH
    if m.any():
        r = _oned(m, oh, True)
        out[m] = per_elem[m][:, None] * r * ow[m][:, None] \
            * oc[m][:, None] * flop_factor[m][:, None]
    m = scheme == Scheme.INW
    if m.any():
        c = _oned(m, ow, True)
        out[m] = per_elem[m][:, None] * oh[m][:, None] * c \
            * oc[m][:, None] * flop_factor[m][:, None]
    m = scheme == Scheme.OUTC
    if m.any():
        h = np.maximum(heads[m], 1)
        ch_head = weighted_split_batch(h, weights) * (oc[m] // h)[:, None]
        ch = np.where((heads[m] > 0)[:, None], ch_head, _oned(m, oc, False))
        out[m] = per_elem[m][:, None] * oh[m][:, None] * ow[m][:, None] \
            * ch * flop_factor[m][:, None]
    m = scheme == Scheme.GRID2D
    if m.any():
        # balanced round-robin cell grid (see hetero_shard_work), replayed
        # in the scalar accumulation order per node
        gh, gw = grid_dims(ndev)
        q_r, rem_r = oh[m] // gh, oh[m] % gh
        q_c, rem_c = ow[m] // gw, ow[m] % gw
        acc = np.zeros((ndev, int(m.sum())), np.float64)
        for j in range(gh * gw):
            r = q_r + (j // gw < rem_r)
            c = q_c + (j % gw < rem_c)
            rr = np.minimum(r + 2 * halo[m], oh[m])
            cc = np.minimum(c + 2 * halo[m], ow[m])
            acc[j % ndev] += per_elem[m] * rr * cc * oc[m] * flop_factor[m]
        out[m] = acc.T
    return out


def boundary_bytes_same_scheme_batch(scheme: np.ndarray, oh: np.ndarray,
                                     ow: np.ndarray, oc: np.ndarray,
                                     nodes: np.ndarray,
                                     next_k: np.ndarray) -> np.ndarray:
    """Vector form of :func:`boundary_bytes_same_scheme`.  Non-spatial rows
    (which the scalar form rejects) yield 0 and must be masked by the
    caller."""
    halo = np.maximum(next_k - 1, 0)
    gh, gw = grid_dims_batch(nodes)
    rows = np.ceil(oh / gh)
    cols = np.ceil(ow / gw)
    vals = np.select(
        [scheme == Scheme.INH, scheme == Scheme.INW,
         scheme == Scheme.GRID2D],
        [2.0 * halo * ow * oc * DTYPE_BYTES,
         2.0 * halo * oh * oc * DTYPE_BYTES,
         2.0 * halo * (cols + rows + halo) * oc * DTYPE_BYTES],
        default=0.0)
    return np.where((halo == 0) | (nodes <= 1), 0.0, vals)


def relayout_bytes_batch(oh: np.ndarray, ow: np.ndarray, oc: np.ndarray,
                         src: np.ndarray, dst: np.ndarray,
                         nodes: np.ndarray) -> np.ndarray:
    """Vector form of :func:`relayout_bytes`."""
    total = (oh * ow * oc) * DTYPE_BYTES
    frac_missing = (nodes - 1) / nodes
    shuffle = (total / nodes) * frac_missing * 2.0
    return np.select(
        [dst == Scheme.OUTC, src == Scheme.OUTC, src == dst],
        [total * frac_missing, shuffle, 0.0],
        default=shuffle)


def relayout_bytes(layer: LayerSpec, src: Scheme, dst: Scheme,
                   nodes: int) -> float:
    """Bytes the busiest node must receive to transform the output of
    ``layer`` from layout ``src`` into the input layout ``dst`` requires.

    OutC destination needs the *full* feature map on every node (the costly
    gather the paper calls out); OutC source means every node holds a channel
    slice of every position, so any spatial destination is an all-to-all.
    """
    total = layer.out_elems() * DTYPE_BYTES
    frac_missing = (nodes - 1) / nodes
    if dst == Scheme.OUTC:
        # every node must hold the full input -> gather everything missing
        return total * frac_missing
    if src == Scheme.OUTC:
        # channel slices -> spatial slices: each node keeps 1/nodes of what it
        # has and scatters the rest; receives (nodes-1)/nodes of its spatial
        # shard from peers.
        return (total / nodes) * frac_missing * 2.0
    if src == dst:
        return 0.0  # same spatial layout; only halo (handled separately)
    # spatial -> different spatial (e.g. InH -> InW): full re-shard
    return (total / nodes) * frac_missing * 2.0
