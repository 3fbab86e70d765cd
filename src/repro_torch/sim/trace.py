"""Trace generation + estimator training (§3.2, "330K pieces of trace data").

On the paper's testbed the traces are wall-clock measurements; here they are
drawn from the analytic testbed physics (``core/cost.py``) with multiplicative
log-normal measurement noise — the same role, no hardware.  The GBDT
estimators are then trained on (features -> log seconds) pairs and plugged
into DPP, giving the full data-driven FCO loop end to end.

Heterogeneous traces: a config with ``cluster_presets`` set additionally
samples ``repro_torch.cluster`` presets (``mixed_fast_slow``, ``stepped``,
``asym_uplink``); those rows carry the per-cluster capability summary
columns (``core.estimator.hetero_summary``) after the exact homogeneous
prefix and are labeled by the heterogeneous batched physics
(``hetero_compute_time_batch_s`` straggler maxes; sync against the
bottleneck-projected compat testbed).  The default (empty-preset) config
is **draw-for-draw identical** to the historical homogeneous stream —
same RNG consumption, same 17/20-column matrices, same labels.

The port of the JAX package's ``sim/trace.py``: sampling is numpy and
draw for draw the reference's stream, the labels come from the port's
batched physics (``repro_torch.core.cost``), and the forests of
:func:`train_estimators` are fit on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cost import (Testbed, Topology, compute_time_batch_s,
                                   hetero_compute_time_batch_s,
                                   sync_time_batch_s)
from repro_torch.core.estimator import (GBDTEstimator, hetero_summary,
                                        i_features, s_features,
                                        testbed_summary)
from repro_torch.core.graph import ConvT, LayerSpec
from repro_torch.core.partition import Scheme
from repro_torch.gbdt import GBDTRegressor

#: the heterogeneous presets a hetero trace config samples by default
HETERO_PRESETS: Tuple[str, ...] = ("mixed_fast_slow", "stepped",
                                   "asym_uplink")


@dataclasses.dataclass
class TraceConfig:
    n_samples: int = 330_000
    noise_sigma: float = 0.05       # log-normal measurement noise
    seed: int = 0
    node_choices: Tuple[int, ...] = (3, 4, 5, 6)
    bw_choices: Tuple[float, ...] = (0.5, 1.0, 5.0)
    topo_choices: Tuple[Topology, ...] = (Topology.RING, Topology.PS,
                                          Topology.MESH)
    #: ``repro_torch.cluster.CLUSTER_PRESETS`` names to sample heterogeneous
    #: rows from.  Empty (the default) keeps the historical homogeneous
    #: stream and the 17/20-column layout; non-empty widens every row by
    #: the capability-summary columns (homogeneous rows carry the uniform
    #: summary) and labels preset rows with the hetero physics.
    cluster_presets: Tuple[str, ...] = ()
    #: fraction of samples drawn on a sampled preset (only consulted when
    #: ``cluster_presets`` is non-empty)
    hetero_fraction: float = 0.5


def hetero_trace_config(**overrides) -> TraceConfig:
    """A :class:`TraceConfig` sampling all heterogeneous presets (the
    config the hetero-trained planner estimator is built from)."""
    kw = dict(cluster_presets=HETERO_PRESETS)
    kw.update(overrides)
    return TraceConfig(**kw)


def _random_layer(rng: np.random.Generator) -> LayerSpec:
    t = ConvT(rng.choice([0, 1, 2, 3, 4, 5, 6],
                         p=[0.33, 0.14, 0.24, 0.08, 0.11, 0.05, 0.05]))
    if t == ConvT.FC:
        seq = int(rng.choice([1, 64, 128, 256, 512]))
        return LayerSpec("t", t, seq, 1, int(rng.choice([256, 512, 768, 1024,
                                                         2048, 3072])),
                         int(rng.choice([256, 512, 768, 1000, 3072])))
    h = int(rng.choice([7, 14, 28, 56, 112, 224]))
    cin = int(rng.choice([3, 16, 32, 64, 128, 256, 512, 1024]))
    if t == ConvT.DWCONV:
        cout, k, s, p = cin, 3, int(rng.choice([1, 2])), 1
    elif t == ConvT.POINTWISE:
        cout, k, s, p = int(rng.choice([16, 32, 64, 128, 256, 512, 1024])), 1, 1, 0
    elif t == ConvT.POOL:
        cout, k, s, p = cin, int(rng.choice([2, 3])), 2, 0
    elif t in (ConvT.ADD, ConvT.CONCAT):
        # multi-input merge: the fan-in feature comes from len(inputs);
        # the dummy producer names never resolve (features only)
        fan = int(rng.integers(2, 5))
        cout, k, s, p = cin, 1, 1, 0
        return LayerSpec("t", t, h, h, cin, cout, k, s, p,
                         inputs=tuple(f"in{j}" for j in range(fan)))
    else:
        cout = int(rng.choice([16, 32, 64, 128, 256, 512]))
        k = int(rng.choice([3, 5, 7]))
        s = int(rng.choice([1, 2]))
        p = k // 2
    if h + 2 * p < k:
        k = 1
        p = 0
    return LayerSpec("t", t, h, h, cin, cout, k, s, p)


def _random_testbed(rng: np.random.Generator, cfg: TraceConfig) -> Testbed:
    return Testbed(nodes=int(rng.choice(cfg.node_choices)),
                   bandwidth_gbps=float(rng.choice(cfg.bw_choices)),
                   topology=Topology(int(rng.choice(cfg.topo_choices))))


def _sample_cluster(rng: np.random.Generator, cfg: TraceConfig,
                    cache: Dict[tuple, object]) -> tuple:
    """Draw one heterogeneous cluster (preset name x node count); clusters
    are memoized so label batching can group rows by cluster key."""
    from repro_torch.cluster.spec import CLUSTER_PRESETS   # lazy: keep the
    # homogeneous import path free of the cluster subsystem
    name = cfg.cluster_presets[int(rng.integers(0,
                                                len(cfg.cluster_presets)))]
    nodes = int(rng.choice(cfg.node_choices))
    key = (name, nodes)
    if key not in cache:
        cache[key] = CLUSTER_PRESETS[name](nodes)
    return key


def _cluster_summary(cluster) -> List[float]:
    return hetero_summary(cluster.capability_weights,
                          [link.bandwidth_gbps for link in cluster.links],
                          cluster.max_latency_us)


def _hetero_i_labels(X: np.ndarray, factors: np.ndarray,
                     keys: List[Optional[tuple]],
                     clusters: Dict[tuple, object]) -> np.ndarray:
    """Batched ground-truth compute times: homogeneous rows through one
    ``compute_time_batch_s`` call, each preset group through one
    ``hetero_compute_time_batch_s`` call (straggler max under the
    cluster's capability weights — exactly what
    ``ClusterAnalyticEstimator.i_cost_batch`` computes)."""
    t = np.empty(len(X), np.float64)
    key_arr = np.asarray(_index(keys))
    hom = key_arr < 0
    if hom.any():
        t[hom] = compute_time_batch_s(X[hom], Testbed(), factors[hom])
    for gi, (key, cl) in enumerate(clusters.items()):
        m = key_arr == gi
        if not m.any():
            continue
        t[m] = hetero_compute_time_batch_s(
            X[m], cl.compat_testbed(),
            np.asarray(cl.speeds_gflops), np.asarray(cl.dev_derates),
            np.asarray(cl.capability_weights), factors[m])
    return t


def _index(keys: List[Optional[tuple]]) -> List[int]:
    """Group index per row: position of the row's cluster key in
    first-seen order (-1 entries are handled by the caller's mask)."""
    order: Dict[tuple, int] = {}
    out = []
    for k in keys:
        if k is None:
            out.append(-1)
        else:
            out.append(order.setdefault(k, len(order)))
    return out


def generate_i_traces(cfg: TraceConfig) -> Tuple[np.ndarray, np.ndarray]:
    """i-Estimator traces: features -> log(compute seconds).

    Sampling stays scalar (it drives the RNG stream, kept draw-for-draw
    identical to the historical loop under the default config), but the
    tens of thousands of ground-truth times come from batched physics
    calls — one per cluster group.  A spatial scheme is required for a
    nonzero halo, so every sampled configuration is valid by construction.
    """
    rng = np.random.default_rng(cfg.seed)
    xs: List[List[float]] = []
    factors: List[float] = []
    noise: List[float] = []
    keys: List[Optional[tuple]] = []
    clusters: Dict[tuple, object] = {}
    while len(xs) < cfg.n_samples:
        layer = _random_layer(rng)
        if cfg.cluster_presets and rng.random() < cfg.hetero_fraction:
            key = _sample_cluster(rng, cfg, clusters)
            cl = clusters[key]
            tb = cl.compat_testbed()
            summary = _cluster_summary(cl)
        else:
            key = None
            tb = _random_testbed(rng, cfg)
            summary = testbed_summary(tb) if cfg.cluster_presets else None
        scheme = Scheme(int(rng.integers(0, 4)))
        halo = 0
        if scheme.spatial and rng.random() < 0.4:
            halo = int(rng.integers(1, 5))
        noise.append(float(np.exp(rng.normal(0.0, cfg.noise_sigma))))
        xs.append(i_features(layer, scheme, tb, halo, hetero=summary))
        factors.append(layer.extra_flop_factor)
        keys.append(key)
    X = np.asarray(xs)
    t = _hetero_i_labels(X, np.asarray(factors), keys, clusters) \
        * np.asarray(noise)
    return X, np.log(np.maximum(t, 1e-9))


def generate_s_traces(cfg: TraceConfig) -> Tuple[np.ndarray, np.ndarray]:
    """s-Estimator traces: features -> log(sync seconds).  Same structure
    as :func:`generate_i_traces`: scalar sampling, batched
    ``sync_time_batch_s`` evaluation per cluster group (heterogeneous
    rows are priced against the bottleneck-projected compat testbed —
    bandwidth/topology travel in the feature columns, the projected link
    latency in ``tb``)."""
    rng = np.random.default_rng(cfg.seed + 1)
    xs: List[List[float]] = []
    noise: List[float] = []
    keys: List[Optional[tuple]] = []
    clusters: Dict[tuple, object] = {}
    while len(xs) < cfg.n_samples:
        layer = _random_layer(rng)
        if cfg.cluster_presets and rng.random() < cfg.hetero_fraction:
            key = _sample_cluster(rng, cfg, clusters)
            cl = clusters[key]
            tb = cl.compat_testbed()
            summary = _cluster_summary(cl)
        else:
            key = None
            tb = _random_testbed(rng, cfg)
            summary = testbed_summary(tb) if cfg.cluster_presets else None
        src = Scheme(int(rng.integers(0, 4)))
        if rng.random() < 0.1:
            nxt, dst = None, None
        else:
            nxt = _random_layer(rng)
            dst = Scheme(int(rng.integers(0, 4)))
        noise.append(float(np.exp(rng.normal(0.0, cfg.noise_sigma))))
        xs.append(s_features(layer, nxt, src, dst, tb, hetero=summary))
        keys.append(key)
    X = np.asarray(xs)
    t = np.empty(len(X), np.float64)
    key_arr = np.asarray(_index(keys))
    hom = key_arr < 0
    if hom.any():
        t[hom] = sync_time_batch_s(X[hom], Testbed())
    for gi, (key, cl) in enumerate(clusters.items()):
        m = key_arr == gi
        if m.any():
            t[m] = sync_time_batch_s(X[m], cl.compat_testbed())
    t *= np.asarray(noise)
    return X, np.log(np.maximum(t, 1e-9))


def train_estimators(cfg: Optional[TraceConfig] = None,
                     gbdt_kwargs: Optional[dict] = None,
                     verbose: bool = False, device="cuda") -> GBDTEstimator:
    """End-to-end: sample traces from the simulator, fit both GBDTs on
    ``device``; ``verbose`` logs each fit's progress every 40 trees
    through ``repro_torch.obs.log`` (``REPRO_LOG``)."""
    cfg = cfg or TraceConfig()
    kw = dict(n_estimators=120, learning_rate=0.15, max_depth=7)
    kw.update(gbdt_kwargs or {})
    xi, yi = generate_i_traces(cfg)
    xs, ys = generate_s_traces(cfg)
    i_model = GBDTRegressor(**kw, seed=cfg.seed, device=device).fit(
        xi, yi, verbose_every=40 if verbose else 0)
    s_model = GBDTRegressor(**kw, seed=cfg.seed + 7, device=device).fit(
        xs, ys, verbose_every=40 if verbose else 0)
    return GBDTEstimator(i_model, s_model)
