"""Execution API of the port: :class:`ExecConfig` + :class:`Session`.

* :class:`ExecConfig` — frozen, hashable *policy*: which backend, which
  executor, whether segments run as cached programs, which device.
* :class:`Session` — *bound state*: one (graph, weights, plan, nodes)
  binding, validated once and run on many inputs.

The device defaults to ``"cuda"``.  A Session on a machine without a card
raises unless the caller asked for ``device="cpu"``: nothing continues on
the CPU by itself.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .engine import BACKENDS, ExecStats, _run_partitioned_local

__all__ = ["ExecConfig", "Session"]


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """Execution policy — everything about *how* to run that is not the
    model, the plan, or the data.

    * ``backend``: segment lowering, ``"cuda"`` (hand-written shard
      kernels with per-record generic fallback) or ``"torch"`` (generic
      ATen ops throughout).
    * ``executor``: ``"local"``, the single-process executor.  The
      multi-device ``"mesh"`` executor is not ported yet.
    * ``jit_segments``: route every segment cell through the cache of
      segment programs (``engine._compiled_segment``; on the card a
      captured CUDA graph each, eager on its first call), as the
      reference's default; ``False`` runs every record eagerly.
    * ``device``: where tensors live and kernels run.
    """

    backend: str = "cuda"
    executor: str = "local"
    jit_segments: bool = True
    device: str = "cuda"

    def __post_init__(self) -> None:
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {BACKENDS}")
        if self.executor == "mesh":
            raise NotImplementedError(
                'executor="mesh" is not ported yet: see ROADMAP.md, queue '
                'A 3, "Mesh executor" (torch.distributed), and A 4, decode '
                'on the mesh executor')
        if self.executor != "local":
            raise ValueError(f"executor {self.executor!r} not in "
                             f"('local',)")
        torch.device(self.device)   # raises on a malformed device string


class Session:
    """One plan bound to the local executor, reusable across many inputs.

    ``Session(graph, weights, plan, nodes, config).run(x)`` validates the
    plan once at construction.  ``weights`` must already lie on
    ``config.device`` (see ``init_weights`` / ``weights_from_numpy``);
    ``run`` moves ``x`` there.
    """

    def __init__(self, graph, weights, plan, nodes: int,
                 config: ExecConfig = ExecConfig()):
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
        if graph.is_chain:
            plan.validate()
            if len(plan) != len(graph):
                raise ValueError("plan/graph length mismatch")
        else:
            plan.validate_for(graph)

    def run(self, x) -> Tuple[torch.Tensor, ExecStats]:
        """Execute the bound plan on ``x`` → ``(output, ExecStats)``."""
        x = torch.as_tensor(x, device=self.device)
        return _run_partitioned_local(self.graph, self.weights, x,
                                      self.plan, self.nodes,
                                      jit_segments=self.config.jit_segments,
                                      backend=self.config.backend)

    def __call__(self, x) -> torch.Tensor:
        """Convenience: ``session(x)`` → output only (stats dropped)."""
        return self.run(x)[0]
