"""Hand-written CUDA shard kernels for the engine hot path, their wrappers
and their plain PyTorch versions.

Public surface: the raw shard kernels :func:`conv2d_shard` and
:func:`matmul_tiled` consumed by the engine's ``backend="cuda"`` path, the
convenience wrappers in :mod:`repro_torch.kernels.ops` (plain fallback on
unsupported geometries), and the plain versions in
:mod:`repro_torch.kernels.ref`.  Importing this package never compiles or
loads a kernel; :mod:`repro_torch.kernels.build` does that at first launch.
"""
from .conv2d import UnsupportedGeometry, conv2d_shard, conv2d_tiled
from .ops import conv2d, dwconv2d, matmul, matmul_tiled

__all__ = [
    "UnsupportedGeometry", "conv2d", "conv2d_shard", "conv2d_tiled",
    "dwconv2d", "matmul", "matmul_tiled",
]
