"""Heterogeneous edge-cluster description — devices, links, presets.

The homogeneous :class:`repro_torch.core.cost.Testbed` describes the
paper's SRIO DSP cluster: one ``device_gflops``, one per-link bandwidth.
Real edge deployments are uneven — DistrEdge-style mixes of fast and slow
boards, asymmetric uplinks — and that unevenness is where
capability-proportional partitioning wins or loses.  :class:`ClusterSpec`
carries the full description: per-device compute capability (gflops,
kernel-efficiency derate, memory) and a per-edge link graph (bandwidth +
latency per link, edge set defined by the topology).

Compatibility contract: ``ClusterSpec.compat_testbed()`` projects the
cluster onto a ``Testbed`` (node count, topology, *bottleneck* link
bandwidth / latency, scheme efficiencies), so every existing call site —
feature extraction, cost tables, DPP — keeps working unchanged.  A
homogeneous cluster's costs through ``ClusterAnalyticEstimator`` are
bit-identical to the historical ``Testbed`` path (tested).

A copy of the JAX package's ``cluster/spec.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.cost import Testbed, Topology
from repro_torch.core.graph import ModelGraph
from repro_torch.core.partition import DTYPE_BYTES


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """One edge device: sustained compute rate, memory, kernel efficiency.

    ``eff_derate`` multiplies the testbed's scheme efficiency on this device
    (e.g. a board whose DSP intrinsics vectorize worse); capability weights
    are proportional to ``gflops * eff_derate``.
    """

    name: str = "dev"
    gflops: float = 16.0          # sustained fp32 GFLOP/s
    mem_mb: float = 512.0
    eff_derate: float = 1.0

    def __post_init__(self) -> None:
        if self.gflops <= 0.0 or self.eff_derate <= 0.0:
            raise ValueError(f"{self.name}: gflops and eff_derate must be "
                             f"positive")


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """One physical link of the cluster interconnect."""

    bandwidth_gbps: float = 5.0
    latency_us: float = 10.0

    def __post_init__(self) -> None:
        if self.bandwidth_gbps <= 0.0 or self.latency_us < 0.0:
            raise ValueError("link bandwidth must be positive, latency "
                             "non-negative")


def topology_edges(nodes: int, topology: Topology) -> Tuple[Tuple[int, int],
                                                            ...]:
    """Undirected edge set of each supported interconnect topology."""
    if nodes <= 1:
        return ()
    if topology == Topology.RING:
        if nodes == 2:
            return ((0, 1),)
        return tuple((i, (i + 1) % nodes) for i in range(nodes))
    if topology == Topology.PS:
        return tuple((0, i) for i in range(1, nodes))
    if topology == Topology.MESH:
        return tuple((i, j) for i in range(nodes) for j in range(i + 1,
                                                                 nodes))
    raise ValueError(topology)


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """A (possibly heterogeneous) edge cluster: devices + link graph.

    ``links[k]`` is the :class:`LinkSpec` of ``topology_edges(n,
    topology)[k]`` — the edge set is fixed by the topology, the per-edge
    capabilities are free.  Scheme efficiencies (``eff_*``) are
    cluster-wide, matching ``Testbed``; per-device variation goes through
    ``DeviceSpec.eff_derate``.
    """

    name: str
    devices: Tuple[DeviceSpec, ...]
    links: Tuple[LinkSpec, ...]
    topology: Topology = Topology.RING
    eff_inh: float = 0.90
    eff_inw: float = 0.80
    eff_outc: float = 0.85
    eff_grid: float = 0.82

    def __post_init__(self) -> None:
        if not self.devices:
            raise ValueError(f"{self.name}: cluster needs >= 1 device")
        n_edges = len(topology_edges(self.n, self.topology))
        if len(self.links) != n_edges:
            raise ValueError(
                f"{self.name}: {self.topology.name} over {self.n} nodes has "
                f"{n_edges} links, got {len(self.links)}")

    # ---- structure --------------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.devices)

    @property
    def edges(self) -> Tuple[Tuple[int, int], ...]:
        return topology_edges(self.n, self.topology)

    @property
    def speeds_gflops(self) -> Tuple[float, ...]:
        return tuple(d.gflops for d in self.devices)

    @property
    def dev_derates(self) -> Tuple[float, ...]:
        return tuple(d.eff_derate for d in self.devices)

    @property
    def capability_weights(self) -> Tuple[float, ...]:
        """Shard-fraction weights: effective throughput per device."""
        return tuple(d.gflops * d.eff_derate for d in self.devices)

    @property
    def is_homogeneous(self) -> bool:
        return (all(d == self.devices[0] for d in self.devices)
                and all(l == self.links[0] for l in self.links))

    # ---- Testbed projection ----------------------------------------------
    @property
    def bottleneck_bw_gbps(self) -> float:
        """Slowest link — the busiest-link bound the analytic s-cost uses."""
        return min((l.bandwidth_gbps for l in self.links), default=5.0)

    @property
    def max_latency_us(self) -> float:
        return max((l.latency_us for l in self.links), default=10.0)

    def compat_testbed(self) -> Testbed:
        """Project onto the homogeneous ``Testbed`` the feature expression
        and cost tables consume: node count, topology, bottleneck link.
        ``device_gflops`` is the lead device's rate (representative only —
        the cluster estimator never reads it)."""
        return Testbed(nodes=self.n,
                       bandwidth_gbps=self.bottleneck_bw_gbps,
                       topology=self.topology,
                       device_gflops=self.devices[0].gflops,
                       link_latency_us=self.max_latency_us,
                       eff_inh=self.eff_inh, eff_inw=self.eff_inw,
                       eff_outc=self.eff_outc, eff_grid=self.eff_grid)

    @classmethod
    def from_testbed(cls, tb: Testbed, name: str = "testbed") -> \
            "ClusterSpec":
        """Lift a homogeneous ``Testbed`` into the cluster IR (the inverse
        of :meth:`compat_testbed` on homogeneous clusters)."""
        dev = DeviceSpec(name="dev", gflops=tb.device_gflops)
        link = LinkSpec(bandwidth_gbps=tb.bandwidth_gbps,
                        latency_us=tb.link_latency_us)
        n_edges = len(topology_edges(tb.nodes, tb.topology))
        return cls(name=name, devices=(dev,) * tb.nodes,
                   links=(link,) * n_edges, topology=tb.topology,
                   eff_inh=tb.eff_inh, eff_inw=tb.eff_inw,
                   eff_outc=tb.eff_outc, eff_grid=tb.eff_grid)

    # ---- memory feasibility ----------------------------------------------
    def memory_ok(self, graph: ModelGraph) -> Tuple[bool, ...]:
        """Rough per-device fit check: full weight set (spatial schemes
        replicate weights) plus the largest capability-weighted activation
        shard (in + out feature maps).  Advisory — the sweep reports it, the
        planner does not enforce it."""
        w_bytes = sum(l.weight_elems() for l in graph.layers) * DTYPE_BYTES
        total = float(np.sum(self.capability_weights))
        out = []
        for d, w in zip(self.devices, self.capability_weights):
            frac = w / total
            act = max((l.in_elems() + l.out_elems()) * DTYPE_BYTES * frac
                      for l in graph.layers)
            out.append((w_bytes + act) <= d.mem_mb * 1e6)
        return tuple(out)


# ---------------------------------------------------------------------------
# Presets — the sweep's cluster zoo, parameterized by node count.
# ---------------------------------------------------------------------------

def homogeneous(nodes: int, bandwidth_gbps: float = 5.0,
                topology: Topology = Topology.RING,
                device_gflops: float = 16.0,
                latency_us: float = 10.0) -> ClusterSpec:
    """Uniform cluster — must reproduce ``Testbed`` costs bit-identically."""
    return ClusterSpec.from_testbed(
        Testbed(nodes=nodes, bandwidth_gbps=bandwidth_gbps,
                topology=topology, device_gflops=device_gflops,
                link_latency_us=latency_us), name=f"uniform{nodes}")


def mixed_fast_slow(nodes: int, n_fast: int = 2, fast_gflops: float = 32.0,
                    slow_gflops: float = 8.0,
                    bandwidth_gbps: float = 5.0) -> ClusterSpec:
    """DistrEdge-style mixed cluster: a few fast boards + many slow ones
    (default shape 2 fast + rest slow, a 4x capability gap)."""
    n_fast = min(n_fast, nodes)
    devs = tuple(DeviceSpec(name=f"fast{i}", gflops=fast_gflops, mem_mb=2048)
                 for i in range(n_fast)) + \
        tuple(DeviceSpec(name=f"slow{i}", gflops=slow_gflops, mem_mb=512)
              for i in range(nodes - n_fast))
    n_edges = len(topology_edges(nodes, Topology.RING))
    return ClusterSpec(name=f"mixed{nodes}", devices=devs,
                       links=(LinkSpec(bandwidth_gbps=bandwidth_gbps),)
                       * n_edges)


def stepped(nodes: int, top_gflops: float = 24.0,
            bottom_gflops: float = 6.0) -> ClusterSpec:
    """Graded capability ramp (every device different — the general case
    for weighted-fraction geometry)."""
    if nodes == 1:
        gf = [top_gflops]
    else:
        step = (top_gflops - bottom_gflops) / (nodes - 1)
        gf = [top_gflops - i * step for i in range(nodes)]
    devs = tuple(DeviceSpec(name=f"d{i}", gflops=g)
                 for i, g in enumerate(gf))
    n_edges = len(topology_edges(nodes, Topology.RING))
    return ClusterSpec(name=f"stepped{nodes}", devices=devs,
                       links=(LinkSpec(),) * n_edges)


def asym_uplink(nodes: int, slow_bw_gbps: float = 0.5,
                fast_bw_gbps: float = 5.0) -> ClusterSpec:
    """Uniform devices, one congested link — the busiest-link bound (and
    the simulator's per-link queues) gate every sync on the slow edge."""
    n_edges = len(topology_edges(nodes, Topology.RING))
    links = (LinkSpec(bandwidth_gbps=slow_bw_gbps),) + \
        (LinkSpec(bandwidth_gbps=fast_bw_gbps),) * max(n_edges - 1, 0)
    return ClusterSpec(name=f"asym{nodes}",
                       devices=(DeviceSpec(),) * nodes,
                       links=links[:n_edges])


#: preset registry for sweeps: name -> (nodes -> ClusterSpec).  Every entry
#: except ``uniform`` is heterogeneous (device- or link-skewed).
CLUSTER_PRESETS: Dict[str, object] = {
    "uniform": homogeneous,
    "mixed_fast_slow": mixed_fast_slow,
    "stepped": stepped,
    "asym_uplink": asym_uplink,
}
