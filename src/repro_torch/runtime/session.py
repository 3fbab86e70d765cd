"""Execution API of the port: :class:`ExecConfig` + :class:`Session`.

* :class:`ExecConfig` — frozen, hashable *policy*: which backend, which
  executor, whether segments run as cached programs, how to instrument,
  how to fail, which device.
* :class:`Session` — *bound state*: one (graph, weights, plan, nodes)
  binding plus, for the mesh executor, the mesh of node streams; validated
  once and run on many inputs.

The device defaults to ``"cuda"``.  A Session on a machine without a card
raises unless the caller asked for ``device="cpu"``: nothing continues on
the CPU by itself.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.launch.mesh import make_nodes_mesh

from .engine import BACKENDS, EXECUTORS, ExecStats, _run_partitioned_local
from .mesh_exec import FALLBACKS, run_partitioned_mesh

__all__ = ["ExecConfig", "Session"]


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """Execution policy — everything about *how* to run that is not the
    model, the plan, or the data.

    * ``backend``: segment lowering, ``"cuda"`` (hand-written shard
      kernels with per-record generic fallback) or ``"torch"`` (generic
      ATen ops throughout).
    * ``executor``: ``"local"``, the single-process executor (the nodes'
      programs one after another), or ``"mesh"``
      (:mod:`~repro_torch.runtime.mesh_exec`: each node a stream of the
      device, one program a pipeline stage, exchanges as device copies).
    * ``jit_segments``: route every local-executor segment cell through
      the cache of segment programs (``engine._compiled_segment``; on the
      card a captured CUDA graph each, eager on its first call), as the
      reference's default; ``False`` runs every record eagerly.  The mesh
      always runs its stages as programs.
    * ``instrument``: record measured per-stage times into ``ExecStats``
      (mesh executor; on the card each stage's graph records its own
      timing events).
    * ``overlap``: fuse halo exchanges into the producing compute stage
      (mesh executor).
    * ``stage_timeout_s`` / ``stage_retries`` / ``fallback``: mesh fault
      policy (watchdog, bounded dispatch retries, degrade-to-local).
    * ``device``: where tensors live and kernels run.
    """

    backend: str = "cuda"
    executor: str = "local"
    jit_segments: bool = True
    instrument: bool = False
    overlap: bool = True
    stage_timeout_s: Optional[float] = None
    stage_retries: int = 0
    fallback: str = "raise"
    device: str = "cuda"

    def __post_init__(self) -> None:
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {BACKENDS}")
        if self.executor not in EXECUTORS:
            raise ValueError(f"executor {self.executor!r} not in "
                             f"{EXECUTORS}")
        if self.fallback not in FALLBACKS:
            raise ValueError(f"fallback {self.fallback!r} not in "
                             f"{FALLBACKS}")
        if self.stage_retries < 0:
            raise ValueError(f"stage_retries must be >= 0, got "
                             f"{self.stage_retries}")
        if self.stage_timeout_s is not None and self.stage_timeout_s <= 0:
            raise ValueError(f"stage_timeout_s must be positive, got "
                             f"{self.stage_timeout_s}")
        torch.device(self.device)   # raises on a malformed device string


class Session:
    """One plan bound to one executor, reusable across many inputs.

    ``Session(graph, weights, plan, nodes, config).run(x)`` validates the
    plan once at construction and, for the mesh executor, builds the mesh
    once (``make_nodes_mesh(nodes, [config.device])``: the one-card
    mapping, a stream a node).  ``weights`` must already lie on
    ``config.device`` (see ``init_weights`` / ``weights_from_numpy``);
    ``run`` moves ``x`` there.

    ``mesh`` optionally passes a prebuilt
    :class:`~repro_torch.launch.mesh.NodesMesh`; ``fault_hook`` is the mesh
    executor's fault-injection test hook.
    """

    def __init__(self, graph, weights, plan, nodes: int,
                 config: ExecConfig = ExecConfig(), *, mesh=None,
                 fault_hook=None):
        if nodes < 1:
            raise ValueError(f"nodes must be >= 1, got {nodes}")
        self.device = torch.device(config.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass "
                "ExecConfig(device='cpu') to run on the CPU")
        self.graph = graph
        self.weights = weights
        self.plan = plan
        self.nodes = nodes
        self.config = config
        self.fault_hook = fault_hook
        if graph.is_chain:
            plan.validate()
            if len(plan) != len(graph):
                raise ValueError("plan/graph length mismatch")
        else:
            plan.validate_for(graph)
        self._mesh = mesh
        if config.executor == "mesh" and mesh is None and nodes > 1:
            try:
                self._mesh = make_nodes_mesh(nodes, [self.device])
            except RuntimeError:
                # too few devices: leave the mesh unset so the executor's
                # fallback policy decides (degrade-to-local vs raise)
                self._mesh = None

    @property
    def mesh(self):
        """The bound mesh of node streams (``None`` for the local executor
        and for one node)."""
        return self._mesh

    def run(self, x) -> Tuple[torch.Tensor, ExecStats]:
        """Execute the bound plan on ``x`` → ``(output, ExecStats)``."""
        x = torch.as_tensor(x, device=self.device)
        cfg = self.config
        if cfg.executor == "mesh":
            return run_partitioned_mesh(
                self.graph, self.weights, x, self.plan, self.nodes,
                backend=cfg.backend, mesh=self._mesh,
                instrument=cfg.instrument,
                overlap=cfg.overlap, stage_timeout_s=cfg.stage_timeout_s,
                stage_retries=cfg.stage_retries, fallback=cfg.fallback,
                fault_hook=self.fault_hook)
        return _run_partitioned_local(self.graph, self.weights, x,
                                      self.plan, self.nodes,
                                      jit_segments=cfg.jit_segments,
                                      backend=cfg.backend)

    def __call__(self, x) -> torch.Tensor:
        """Convenience: ``session(x)`` → output only (stats dropped)."""
        return self.run(x)[0]
