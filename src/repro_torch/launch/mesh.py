"""The mesh of planned nodes: the port of ``repro/launch/mesh.py::
make_nodes_mesh``.

The reference places each planned node on its own JAX device, one
process driving them all (``jit(shard_map(...))`` over a 1-D ``nodes``
axis).  The port keeps that single controller on one card: each node is
a CUDA stream of the card, so the nodes' shard programs run concurrently
and exchange data by device-to-device copies ordered by events
(:mod:`repro_torch.runtime.mesh_exec`).  This is the one-card mapping: a
device list of one device puts every node on it, one stream each.  A
one-node mesh and a mesh on the CPU have no streams: their nodes run one
after another on the calling stream (:meth:`NodesMesh.run`), which is
also how the local executors run the nodes' parts.

A mesh over several cards (one node a card) is not ported: it raises
``NotImplementedError`` naming ROADMAP.md queue A 10.

The LM planner's meshes (the port of ``make_production_mesh`` and
``make_local_mesh``) are :class:`ShapeMesh` objects: axis names and sizes,
which is all the sharding rules, the planner and the dry run read.  The
production meshes keep the reference's shapes, 16 x 16 and 2 x 16 x 16
(256 and 512 H100s), so the rules meet the divisibility structure they
were written for; only the physics changes, to the H100 SXM's constants
below.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

__all__ = ["HBM_BW", "LINK_BW", "NodesMesh", "PEAK_FLOPS_BF16", "ShapeMesh",
           "check_mesh", "make_local_mesh", "make_nodes_mesh",
           "make_production_mesh"]

# H100 SXM hardware constants (the roofline's denominators), per card
PEAK_FLOPS_BF16 = 989e12          # dense bf16 tensor cores
HBM_BW = 3.35e12                  # bytes/s, HBM3
#: bytes/s a card sends on the production mesh: one 400 Gb/s ConnectX-7
#: NIC per GPU (NVIDIA DGX H100 datasheet: 8 GPUs and 8 x 400 Gb/s a
#: node).  A 16-wide ``model`` axis spans two 8-GPU NVLink nodes, so its
#: ring crosses InfiniBand; an axis of at most 8 cards would see NVLink
#: 4's 450 GB/s a direction instead, which is not used here.
LINK_BW = 50e9

AXIS = "nodes"


class NodesMesh:
    """``nodes`` planned nodes on one device: ``devices[n]`` is node
    ``n``'s device and ``streams[n]`` its stream; ``streams`` is ``()``
    where the nodes run one after another on the calling stream (one
    node, the CPU, or a local executor's ``NodesMesh([device] * n)``)."""

    def __init__(self, devices: Sequence[torch.device],
                 streams: Sequence["torch.cuda.Stream"] = ()):
        self.devices: Tuple[torch.device, ...] = tuple(devices)
        self.streams = tuple(streams)

    @property
    def shape(self) -> Dict[str, int]:
        """``{"nodes": N}``, the reference mesh's axis sizes."""
        return {AXIS: len(self.devices)}

    @property
    def device(self) -> torch.device:
        """The one device every node lies on."""
        return self.devices[0]

    def run(self, *phases: Callable[[int], object],
            marks: Optional[Callable[[int], None]] = None) -> list:
        """One program over all nodes: fork (every node stream waits on
        the calling stream), run ``phase(nd)`` for every node on its
        stream, phase after phase, and join (the calling stream waits on
        every node stream).  ``marks(nd)`` is called on node ``nd``'s
        stream after its last phase.  Returns the last phase's results in
        node order."""
        cur = torch.cuda.current_stream(self.device) if self.streams \
            else None
        for s in self.streams:
            s.wait_stream(cur)
        res: list = []
        for i, phase in enumerate(phases):
            res = []
            for nd in range(len(self.devices)):
                with torch.cuda.stream(self.streams[nd] if self.streams
                                       else None):
                    res.append(phase(nd))
                    if marks is not None and i + 1 == len(phases):
                        marks(nd)
        for s in self.streams:
            cur.wait_stream(s)
        return res

    def event(self) -> Optional["torch.cuda.Event"]:
        """An event recorded on the current (node) stream, for another
        node's :meth:`receive`; None without streams."""
        if not self.streams:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def receive(self, t: torch.Tensor, nd: int,
                ev: Optional["torch.cuda.Event"]) -> torch.Tensor:
        """A copy of ``t`` (made on another node's stream, which recorded
        ``ev`` after it) on node ``nd``'s stream: the device-to-device
        copy of a halo exchange."""
        if self.streams:
            torch.cuda.current_stream(self.device).wait_event(ev)
            t.record_stream(self.streams[nd])
        return t.clone()


def _canonical(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def check_mesh(mesh: NodesMesh, nodes: int, device) -> None:
    """Raise ``ValueError`` unless ``mesh`` is a 1-D mesh of ``nodes``
    nodes on ``device``."""
    if mesh.shape != {AXIS: nodes}:
        raise ValueError(f"mesh must be 1-D over axis {AXIS!r} with size "
                         f"{nodes}, got {mesh.shape}")
    if mesh.device != _canonical(device):
        raise ValueError(f"the mesh lies on {mesh.device}, the run on "
                         f"{device}")


def make_nodes_mesh(nodes: int,
                    devices: Optional[Sequence] = None) -> NodesMesh:
    """The 1-D mesh over ``nodes`` planned nodes.

    ``devices`` (default ``["cuda"]``) lists the devices to place them
    on: one device takes every node (the one-card mapping), a longer list
    gives node ``n`` the list's ``n``-th device.  On the card each node
    of a mesh of several nodes gets a stream of its own; one node, or the
    CPU, gets none.  A list shorter than the nodes (other than one
    device) raises ``RuntimeError``, as does a CUDA device the machine
    does not have; nodes that would lie on several devices raise
    ``NotImplementedError``."""
    if nodes < 1:
        raise ValueError(f"nodes must be >= 1, got {nodes}")
    devs = [_canonical(d) for d in (["cuda"] if devices is None
                                    else devices)]
    if len(devs) == 1:
        devs = devs * nodes
    if len(devs) < nodes:
        raise RuntimeError(
            f"mesh nodes={nodes} needs one device a node or one device for "
            f"all, found {len(devs)}; pass devices=[{devs[0]!r}] to map "
            f"every node onto one device (the one-card mapping: a CUDA "
            f"stream a node)")
    devs = devs[:nodes]
    if len(set(devs)) > 1:
        raise NotImplementedError(
            f"a mesh over several devices ({sorted(map(str, set(devs)))}) "
            f"is not ported: see ROADMAP.md, queue A 10, the mesh over "
            f"several cards; pass devices=[{devs[0]!r}] for the one-card "
            f"mapping")
    dev = devs[0]
    if dev.type == "cuda":
        found = torch.cuda.device_count()
        if dev.index is None or dev.index >= found:
            raise RuntimeError(
                f"mesh device {dev} not present: the machine has {found} "
                f"CUDA device(s); pass devices=[torch.device('cpu')] to "
                f"run the nodes on the CPU")
        if nodes > 1:
            return NodesMesh(devs, [torch.cuda.Stream(dev)
                                    for _ in range(nodes)])
    return NodesMesh(devs)


class ShapeMesh:
    """A mesh as the LM planner sees it: ``axis_names``, ``shape`` (axis
    name -> size) and ``size``.  It holds no devices: the port plans for
    the production meshes of 256 and 512 cards on one card (the
    reference builds them over 512 fake CPU devices)."""

    def __init__(self, shape: Dict[str, int]):
        self.shape: Dict[str, int] = dict(shape)
        self.axis_names: Tuple[str, ...] = tuple(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def __repr__(self) -> str:
        return f"ShapeMesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """The reference's production mesh shapes: ``(data 16, model 16)``, or
    ``(pod 2, data 16, model 16)`` with ``multi_pod``; shape only."""
    if multi_pod:
        return ShapeMesh({"pod": 2, "data": 16, "model": 16})
    return ShapeMesh({"data": 16, "model": 16})


def make_local_mesh(model_axis: int = 1) -> ShapeMesh:
    """The mesh over the cards present, ``model_axis`` of them on the
    ``model`` axis and the rest on ``data``; one H100 gives (1, 1), and so
    does a machine with no card (the CPU)."""
    n = max(1, torch.cuda.device_count())
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the "
                         f"{n} card(s) present")
    return ShapeMesh({"data": n // model_axis, "model": model_axis})
