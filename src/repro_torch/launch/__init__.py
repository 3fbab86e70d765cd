"""Placement of the planned nodes: :func:`make_nodes_mesh` (one CUDA
stream a node on one card); the LM planner's shape-only meshes
(:func:`make_production_mesh`, :func:`make_local_mesh`) and the H100's
roofline constants."""
from .mesh import (HBM_BW, LINK_BW, PEAK_FLOPS_BF16, NodesMesh, ShapeMesh,
                   make_local_mesh, make_nodes_mesh, make_production_mesh)

__all__ = ["HBM_BW", "LINK_BW", "NodesMesh", "PEAK_FLOPS_BF16", "ShapeMesh",
           "make_local_mesh", "make_nodes_mesh", "make_production_mesh"]
