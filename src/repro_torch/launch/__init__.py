"""Placement of the planned nodes: :func:`make_nodes_mesh` (one CUDA
stream a node on one card)."""
from .mesh import NodesMesh, make_nodes_mesh

__all__ = ["NodesMesh", "make_nodes_mesh"]
