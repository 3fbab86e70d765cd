"""Analytic cost model — the simulated testbed "physics".

On real hardware these times would be measured; here (no SRIO DSP cluster)
the analytic model is both (a) the ground truth the trace generator samples
from when training the GBDT estimators and (b) the oracle the Theorem-1
property tests compare DPP against.  The model captures the effects the paper
measures: straggler imbalance, scheme-dependent efficiency, per-message
latency, topology (ring / PS / mesh) and bandwidth.

A copy of the JAX package's ``core/cost.py``: the scalar and batched
homogeneous physics and the heterogeneous-cluster compute times.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence, Tuple

import numpy as np

from .graph import ConvT, LayerSpec
from .partition import (Scheme, boundary_bytes_same_scheme,
                        boundary_bytes_same_scheme_batch,
                        conv_flops_per_elem_batch, hetero_flops_batch,
                        hetero_shard_work, relayout_bytes,
                        relayout_bytes_batch, shard_work,
                        straggler_flops_batch)


class Topology(enum.IntEnum):
    RING = 0
    PS = 1     # parameter-server (star)
    MESH = 2   # full bisection, direct point-to-point


#: multiplier on bytes-on-busiest-link per topology (single source for the
#: scalar and batched paths)
_TOPO_FACTOR = {Topology.RING: 1.0, Topology.PS: 2.0, Topology.MESH: 0.7}

#: kernel-efficiency derate per layer category (low arithmetic intensity)
_CONV_T_DERATE = {ConvT.DWCONV: 0.45, ConvT.POOL: 0.60,
                  ConvT.ADD: 0.30, ConvT.CONCAT: 0.30}


@dataclasses.dataclass(frozen=True)
class Testbed:
    """Edge cluster description (Fig. 4 features 11-12 + node count)."""

    nodes: int = 4
    bandwidth_gbps: float = 5.0          # per-link, SRIO in the paper
    topology: Topology = Topology.RING
    device_gflops: float = 16.0          # TMS320C6678 ~16 GFLOP/s fp32
    link_latency_us: float = 10.0        # per message
    # scheme-dependent kernel efficiency: contiguous row splits vectorize
    # better on the DSP than column or channel splits.
    eff_inh: float = 0.90
    eff_inw: float = 0.80
    eff_outc: float = 0.85
    eff_grid: float = 0.82

    def efficiency(self, scheme: Scheme) -> float:
        return {Scheme.INH: self.eff_inh, Scheme.INW: self.eff_inw,
                Scheme.OUTC: self.eff_outc, Scheme.GRID2D: self.eff_grid}[scheme]

    def topo_factor(self) -> float:
        """Multiplier on bytes-on-busiest-link."""
        return _TOPO_FACTOR[self.topology]

    def comm_time_s(self, bytes_busiest: float, n_messages: int = 2) -> float:
        if bytes_busiest <= 0.0:
            return 0.0
        bw = self.bandwidth_gbps * 1e9 / 8.0  # bytes/s
        return (bytes_busiest * self.topo_factor() / bw
                + n_messages * self.link_latency_us * 1e-6)


def compute_time_s(layer: LayerSpec, scheme: Scheme, tb: Testbed,
                   extra_halo: int = 0) -> float:
    """i-Estimator ground truth: straggler compute time of one layer."""
    work = shard_work(layer, scheme, tb.nodes, extra_halo=extra_halo)
    eff = tb.efficiency(scheme)
    derate = _CONV_T_DERATE.get(layer.conv_t)
    if derate is not None:
        eff *= derate
    return work.straggler_flops / (tb.device_gflops * 1e9 * eff)


def sync_bytes_messages(layer: LayerSpec, nxt: Optional[LayerSpec],
                        src: Scheme, dst: Optional[Scheme],
                        nodes: int) -> Tuple[float, int]:
    """Busiest-node byte volume and message count of one T-mode boundary —
    the topology-independent half of :func:`sync_time_s`, shared with the
    cluster simulator's per-link transfer accounting.

    ``nxt=None``/``dst=None`` means final layer: gather to node 0.
    """
    if nxt is None or dst is None:
        total = layer.out_elems() * 4.0
        return total * (nodes - 1) / nodes, nodes - 1
    if nxt.conv_t == ConvT.ATTN and dst.spatial:
        # attention reads the whole sequence (every position is KV for every
        # query), so a sequence-sharded successor still needs the full input:
        # all-gather, regardless of how src and dst layouts relate.
        total = layer.out_elems() * 4.0
        return total * (nodes - 1) / nodes, 2 * (nodes - 1)
    if src == dst and src.spatial:
        b = boundary_bytes_same_scheme(layer, nxt, src, nodes)
        return b, 2 if b else 0
    b = relayout_bytes(layer, src, dst, nodes)
    halo = 0.0
    if dst.spatial:
        halo = boundary_bytes_same_scheme(layer, nxt, dst, nodes)
    return b + halo, 2 * (nodes - 1)


def sync_time_s(layer: LayerSpec, nxt: Optional[LayerSpec], src: Scheme,
                dst: Optional[Scheme], tb: Testbed) -> float:
    """s-Estimator ground truth: time to make ``layer``'s output available in
    the layout the next layer's scheme requires (T-mode boundary).

    ``nxt=None`` means final layer: outputs are gathered to node 0.
    """
    b, msgs = sync_bytes_messages(layer, nxt, src, dst, tb.nodes)
    return tb.comm_time_s(b, n_messages=msgs)


# ---------------------------------------------------------------------------
# Heterogeneous-cluster compute times (capability-weighted shard fractions).
#
# The per-device capability arrays come from
# ``repro_torch.cluster.ClusterSpec`` (kept as plain sequences here so core
# stays import-cycle free).  ``tb``
# supplies the scheme efficiencies and node count exactly as in the
# homogeneous path; per-device speed enters as ``gflops_d`` and a
# kernel-efficiency derate ``e_d``.  Straggler time = max over per-device
# compute — with uniform devices and weights every expression reduces
# bit-identically to :func:`compute_time_s`.
# ---------------------------------------------------------------------------

def hetero_device_times_s(layer: LayerSpec, scheme: Scheme, tb: Testbed,
                          speeds_gflops: Sequence[float],
                          dev_derates: Sequence[float],
                          weights: Sequence[float],
                          extra_halo: int = 0) -> np.ndarray:
    """Per-device compute seconds of one layer on a heterogeneous cluster
    (the straggler max of this vector is :func:`hetero_compute_time_s`; the
    full vector feeds the discrete-event simulator's device queues)."""
    work = hetero_shard_work(layer, scheme, weights, extra_halo=extra_halo)
    eff = tb.efficiency(scheme)
    derate = _CONV_T_DERATE.get(layer.conv_t)
    if derate is not None:
        eff *= derate
    return np.asarray([f / (g * 1e9 * (eff * e))
                       for f, g, e in zip(work.flops_per_node, speeds_gflops,
                                          dev_derates)], np.float64)


def hetero_compute_time_s(layer: LayerSpec, scheme: Scheme, tb: Testbed,
                          speeds_gflops: Sequence[float],
                          dev_derates: Sequence[float],
                          weights: Sequence[float],
                          extra_halo: int = 0) -> float:
    """i-Estimator ground truth on a heterogeneous cluster: straggler time
    = max over per-device compute under capability-weighted shards."""
    return float(np.max(hetero_device_times_s(
        layer, scheme, tb, speeds_gflops, dev_derates, weights,
        extra_halo=extra_halo)))


def hetero_compute_time_batch_s(X: np.ndarray, tb: Testbed,
                                speeds_gflops: np.ndarray,
                                dev_derates: np.ndarray,
                                weights: np.ndarray,
                                flop_factor: Optional[np.ndarray] = None
                                ) -> np.ndarray:
    """Vector form of :func:`hetero_compute_time_s` over an ``(n, 17)``
    i-feature matrix with one fixed cluster.  Float expressions mirror the
    scalar op order, so any row bit-matches the scalar call."""
    X = np.asarray(X, np.float64)
    conv_t = X[:, _F_CONV_T].astype(np.int64)
    scheme = X[:, _F_SCHEME].astype(np.int64)
    oh = X[:, _F_OUT_H].astype(np.int64)
    ow = X[:, _F_OUT_W].astype(np.int64)
    oc = X[:, _F_OUT_C].astype(np.int64)
    halo = X[:, _F_HALO].astype(np.int64)
    factor = (np.ones(len(X), np.float64) if flop_factor is None
              else np.asarray(flop_factor, np.float64))
    per = conv_flops_per_elem_batch(conv_t, X[:, _F_IN_C], X[:, _F_K],
                                    X[:, _F_FAN_IN])
    flops = hetero_flops_batch(per, oh, ow, oc, scheme, halo, factor,
                               np.asarray(weights, np.float64),
                               heads=X[:, _F_HEADS].astype(np.int64))
    eff = np.asarray([tb.eff_inh, tb.eff_inw, tb.eff_outc,
                      tb.eff_grid])[scheme]
    for ct, derate in _CONV_T_DERATE.items():
        eff = np.where(conv_t == ct, eff * derate, eff)
    denom = np.asarray(speeds_gflops, np.float64)[None, :] * 1e9 \
        * (eff[:, None] * np.asarray(dev_derates, np.float64)[None, :])
    return (flops / denom).max(axis=1)


# ---------------------------------------------------------------------------
# Batched forms over stacked feature matrices.
#
# Row layout matches ``estimator.i_features`` / ``estimator.s_features``
# (asserted against I_FEATURE_NAMES / S_FEATURE_NAMES there).  Per-sample
# testbed variation travels in the BW / Topo / Nodes columns; the remaining
# physics constants (device_gflops, link latency, kernel efficiencies) come
# from the ``tb`` argument.  Float expressions mirror the scalar op order,
# so for any row the batched time is bit-identical to the scalar one.
# ---------------------------------------------------------------------------

# shared leading columns of both feature layouts
(_F_IN_H, _F_IN_W, _F_IN_C, _F_OUT_H, _F_OUT_W, _F_OUT_C, _F_K, _F_S, _F_P,
 _F_CONV_T, _F_FAN_IN, _F_HEADS, _F_BW, _F_TOPO, _F_NODES) = range(15)
# i-feature tail
_F_SCHEME, _F_HALO = 15, 16
# s-feature tail
_F_SRC, _F_DST, _F_NEXT_K, _F_NEXT_FAN, _F_NEXT_CONV_T = 15, 16, 17, 18, 19

_TOPO_FACTORS = np.asarray([_TOPO_FACTOR[t] for t in Topology])


def _comm_time_batch(tb: Testbed, bytes_busiest: np.ndarray,
                     n_messages: np.ndarray, bw_gbps: np.ndarray,
                     topo: np.ndarray) -> np.ndarray:
    """Vector form of :meth:`Testbed.comm_time_s` with per-row BW/topology."""
    bw = bw_gbps * 1e9 / 8.0
    t = (bytes_busiest * _TOPO_FACTORS[topo] / bw
         + n_messages * tb.link_latency_us * 1e-6)
    return np.where(bytes_busiest <= 0.0, 0.0, t)


def compute_time_batch_s(X: np.ndarray, tb: Testbed,
                         flop_factor: Optional[np.ndarray] = None
                         ) -> np.ndarray:
    """Vector form of :func:`compute_time_s` over an ``(n, 17)`` i-feature
    matrix.  ``flop_factor`` carries ``LayerSpec.extra_flop_factor`` (not
    part of the learned feature expression; defaults to 1)."""
    X = np.asarray(X, np.float64)
    conv_t = X[:, _F_CONV_T].astype(np.int64)
    scheme = X[:, _F_SCHEME].astype(np.int64)
    oh = X[:, _F_OUT_H].astype(np.int64)
    ow = X[:, _F_OUT_W].astype(np.int64)
    oc = X[:, _F_OUT_C].astype(np.int64)
    nodes = X[:, _F_NODES].astype(np.int64)
    halo = X[:, _F_HALO].astype(np.int64)
    factor = (np.ones(len(X), np.float64) if flop_factor is None
              else np.asarray(flop_factor, np.float64))
    per = conv_flops_per_elem_batch(conv_t, X[:, _F_IN_C], X[:, _F_K],
                                    X[:, _F_FAN_IN])
    work = straggler_flops_batch(per, oh, ow, oc, scheme, nodes, halo,
                                 factor,
                                 heads=X[:, _F_HEADS].astype(np.int64))
    eff = np.asarray([tb.eff_inh, tb.eff_inw, tb.eff_outc,
                      tb.eff_grid])[scheme]
    for ct, derate in _CONV_T_DERATE.items():
        eff = np.where(conv_t == ct, eff * derate, eff)
    return work / (tb.device_gflops * 1e9 * eff)


def sync_time_batch_s(X: np.ndarray, tb: Testbed) -> np.ndarray:
    """Vector form of :func:`sync_time_s` over an ``(n, 20)`` s-feature
    matrix (``Dst = -1`` encodes the final gather-to-root)."""
    X = np.asarray(X, np.float64)
    oh = X[:, _F_OUT_H].astype(np.int64)
    ow = X[:, _F_OUT_W].astype(np.int64)
    oc = X[:, _F_OUT_C].astype(np.int64)
    nodes = X[:, _F_NODES].astype(np.int64)
    src = X[:, _F_SRC].astype(np.int64)
    dst = X[:, _F_DST].astype(np.int64)
    next_k = X[:, _F_NEXT_K].astype(np.int64)
    next_conv_t = X[:, _F_NEXT_CONV_T].astype(np.int64)
    topo = X[:, _F_TOPO].astype(np.int64)
    bw = X[:, _F_BW]

    final = dst < 0
    src_spatial = src != Scheme.OUTC
    dst_spatial = (dst != Scheme.OUTC) & ~final
    same_spatial = (src == dst) & src_spatial
    next_attn = (next_conv_t == ConvT.ATTN) & dst_spatial

    total = (oh * ow * oc) * 4.0
    gather_b = total * (nodes - 1) / nodes

    halo_src = boundary_bytes_same_scheme_batch(src, oh, ow, oc, nodes,
                                                next_k)
    halo_dst = boundary_bytes_same_scheme_batch(dst, oh, ow, oc, nodes,
                                                next_k)
    relay_b = relayout_bytes_batch(oh, ow, oc, src, dst, nodes) \
        + np.where(dst_spatial, halo_dst, 0.0)

    bytes_b = np.where(final, gather_b,
                       np.where(next_attn, gather_b,
                                np.where(same_spatial, halo_src, relay_b)))
    msgs = np.where(final, nodes - 1,
                    np.where(next_attn, 2 * (nodes - 1),
                             np.where(same_spatial,
                                      np.where(halo_src != 0.0, 2, 0),
                                      2 * (nodes - 1))))
    return _comm_time_batch(tb, bytes_b, msgs, bw, topo)
