"""FC matmul kernel for the H100, the model-layout flash attention and
the conv convenience wrappers.

:func:`matmul_tiled` is the port of the Pallas TPU kernel
``repro/kernels/ops.py::matmul_tiled``: ``[M, Cin] @ [Cin, Cout]`` with f32
accumulation, computed by the hand-written weight-streaming kernel in
``csrc/matmul_tiled.cu`` (the 1x1 case of the implicit-GEMM tile loop in
``csrc/gemm_f32.cuh``; no library GEMM).  :mod:`repro_torch.kernels.gemm`
picks its tile, K split and load widths per call; a split call also runs
the kernel's reduction pass, and still counts one launch.  It raises
:class:`UnsupportedGeometry` on a zero-size dimension; CPU tensors run the
plain version, CUDA tensors launch the kernel or raise (see
:mod:`repro_torch.kernels.conv2d` for the dispatch rules).  The weight is
read through its leading dimension, so the plan's column slice
``w[:, c0:c1]`` is not copied.  ``matmul_tiled.launches`` counts the
calls that ran the kernel.

``flash_attention`` is the reference's public attention wrapper on the
model layout ``[B, H, S, hd]`` with ``[B, KV, S, hd]`` keys and values
(GQA): it runs the kernel of
:func:`repro_torch.kernels.flash_attention.flash_attention_bh`, which
indexes the kv head of each query head and masks keys at or past S, so
neither the head repeat nor the sequence padding of the reference's
wrapper happens here.

``matmul`` / ``conv2d`` / ``dwconv2d`` route through the kernels for any
supported geometry and fall back to the plain versions on
:class:`UnsupportedGeometry` only.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import build, gemm
from .conv2d import UnsupportedGeometry, conv2d_shard, on_cpu
from .flash_attention import attention
from .ref import conv2d_ref, dwconv2d_ref, matmul_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: [B, H, S, hd]; k/v: [B, KV, S, hd] with H % KV == 0; float32 or
    bfloat16 on the card.  Scale 1/sqrt(hd), as the reference's."""
    return attention(q, k, v, causal=causal, window=window,
                     scale=1.0 / math.sqrt(q.shape[-1]))


def matmul_tiled(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [M, Cin] @ w: [Cin, Cout].  Engine FC shards are [seq, Cin] with
    Cout possibly channel-sliced by the plan — any shape goes."""
    M, cin = x.shape
    if w.shape[0] != cin:
        raise ValueError(f"matmul shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not chain")
    cout = w.shape[1]
    if M == 0 or cin == 0 or cout == 0:
        raise UnsupportedGeometry(
            f"degenerate matmul {tuple(x.shape)} @ {tuple(w.shape)}")
    if on_cpu(x, w):
        return matmul_ref(x, w)
    if x.stride(1) != 1 or w.stride(1) != 1:
        raise RuntimeError(f"matmul_tiled needs unit column strides, got "
                           f"{x.stride()} and {w.stride()}")
    out = torch.empty((M, cout), dtype=torch.float32, device=x.device)
    ws, ws_ptr, tail = gemm.launch_args(x, w, M, cout, cin, cin)
    lib = build.load("matmul_tiled")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.matmul_tiled_f32(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                              ws_ptr, M, cout, cin, x.stride(0), w.stride(0),
                              cout, *tail, stream)
    if rc != 0:
        raise RuntimeError(f"matmul_tiled launch failed: cudaError {rc}")
    matmul_tiled.launches += 1
    return out


matmul_tiled.launches = 0


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`matmul_tiled` with the plain fallback on degenerate shapes."""
    try:
        return matmul_tiled(x, w)
    except UnsupportedGeometry:
        return matmul_ref(x, w)


def conv2d(x: torch.Tensor, w: torch.Tensor, *, padding: int = 0,
           stride: int = 1) -> torch.Tensor:
    """x: [H, W, Cin]; w: [K, K, Cin, Cout]; any stride.  Kernel path for
    every non-degenerate square-kernel geometry; degenerate outputs
    (``out_h/out_w <= 0``) fall back to the plain version."""
    try:
        return conv2d_shard(x, w, pads=(padding,) * 4, stride=stride)
    except UnsupportedGeometry:
        return conv2d_ref(x, w, padding=padding, stride=stride)


def dwconv2d(x: torch.Tensor, w: torch.Tensor, *, padding: int = 0,
             stride: int = 1) -> torch.Tensor:
    """Depthwise conv: x [H, W, C]; w [K, K, 1, C] (engine layout)."""
    try:
        return conv2d_shard(x, w, pads=(padding,) * 4, stride=stride,
                            depthwise=True)
    except UnsupportedGeometry:
        return dwconv2d_ref(x, w, padding=padding, stride=stride)
