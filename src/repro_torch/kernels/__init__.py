"""Hand-written CUDA kernels for the port's hot paths, their wrappers and
their plain PyTorch versions.

Public surface: the raw shard kernels :func:`conv2d_shard` and
:func:`matmul_tiled` consumed by the engine's ``backend="cuda"`` path, the
paged decode attention :func:`flash_decode_paged` consumed by
``DecodeSession(backend="cuda")``, the flash attention
:func:`flash_attention_bh`, the convenience wrappers in
:mod:`repro_torch.kernels.ops` (``flash_attention`` on the model layout;
plain fallback on unsupported conv/FC geometries), and the plain versions
in :mod:`repro_torch.kernels.ref`.  Importing this package never compiles
or loads a kernel; :mod:`repro_torch.kernels.build` does that at first
launch.
"""
from .conv2d import UnsupportedGeometry, conv2d_shard, conv2d_tiled
from .flash_attention import NEG_INF, flash_attention_bh, flash_decode_paged
from .ops import conv2d, dwconv2d, flash_attention, matmul, matmul_tiled

__all__ = [
    "NEG_INF", "UnsupportedGeometry", "conv2d", "conv2d_shard",
    "conv2d_tiled", "dwconv2d", "flash_attention", "flash_attention_bh",
    "flash_decode_paged", "matmul", "matmul_tiled",
]
