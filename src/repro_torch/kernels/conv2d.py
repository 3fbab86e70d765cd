"""conv2d shard kernel for the H100 — the FlexPie compute hot spot.

:func:`conv2d_shard` computes one conv shard over the NT-mode local slice
(own rows plus halo rows, never zero-padded in memory) with the shard's
graph-boundary zero ``pads`` applied inside the kernel as masked loads.  It
is the port of the Pallas TPU kernel ``repro/kernels/conv2d.py::
conv2d_shard``: same signature (less the TPU tile size), same
:class:`UnsupportedGeometry` rules, checked before any launch.

Dispatch is by device.  CPU tensors run the plain version
(:func:`repro_torch.kernels.ref.conv2d_shard_ref`), the counterpart of the
reference's interpret mode.  CUDA tensors launch the hand-written kernel
in ``csrc/conv2d_shard.cu`` or raise: a wrong device, dtype or stride is a
``TypeError``/``RuntimeError`` and a failed build or launch a
``RuntimeError``, never an ``UnsupportedGeometry``, so the engine's
per-record geometry fallback cannot swallow them.  The input is read in
place through its row/column strides and the weight through its four
strides: the engine's halo slice ``x[r0:r1, c0:c1, :]`` and an OutC shard's
``w[..., c0:c1]`` are never copied.  Dense shards run the implicit-GEMM
tile loop of ``csrc/gemm_f32.cuh``, whose tile, K split and load widths
:mod:`repro_torch.kernels.gemm` picks per call (a split call also runs
the kernel's reduction pass); depthwise shards run their own kernel.
``conv2d_shard.launches`` counts the calls that ran the kernel, one per
call.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build, gemm
from .ref import conv2d_shard_ref

Pads = Tuple[int, int, int, int]   # (top, bottom, left, right)


class UnsupportedGeometry(ValueError):
    """Raised when a conv geometry cannot be lowered to the shard kernel
    (callers fall back to the generic path)."""


def shard_out_shape(in_h: int, in_w: int, k: int, stride: int,
                    pads: Pads) -> Tuple[int, int]:
    """Output (H, W) of a conv over a [in_h, in_w] shard with explicit
    per-side zero padding ``pads`` and square kernel ``k``."""
    pt, pb, pl_, pr = pads
    out_h = (in_h + pt + pb - k) // stride + 1
    out_w = (in_w + pl_ + pr - k) // stride + 1
    return out_h, out_w


def on_cpu(*tensors: torch.Tensor, dtypes=(torch.float32,)) -> bool:
    """True when every operand lies on the CPU (plain-version dispatch);
    False when they all lie on one CUDA device with one dtype among
    ``dtypes``; raises ``TypeError`` for any other placement or dtype."""
    devs = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devs):
        return True
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise TypeError(f"kernel operands must all lie on the CPU or all on "
                        f"one CUDA device, got {sorted(map(str, devs))}")
    kinds = {t.dtype for t in tensors}
    if len(kinds) != 1 or not kinds <= set(dtypes):
        raise TypeError(f"this CUDA kernel takes one dtype among {dtypes}, "
                        f"got {sorted(map(str, kinds))}")
    return False


def conv2d_shard(x: torch.Tensor, w: torch.Tensor, *,
                 pads: Pads = (0, 0, 0, 0), stride: int = 1,
                 depthwise: bool = False) -> torch.Tensor:
    """One conv shard over the NT-mode local layout.

    ``x``: [Hl, Wl, Cin] — the node's raw input slice, halo rows included,
    NOT zero-padded.  ``w``: [K, K, Cin, Cout] (depthwise: [K, K, 1, C]).
    ``pads`` is the logical zero padding of this shard's position in the
    full feature map (interior shards: all zero — their "padding" is real
    halo data already inside ``x``).
    """
    K = w.shape[0]
    if w.shape[1] != K:
        raise UnsupportedGeometry(f"non-square kernel {tuple(w.shape[:2])}")
    if stride < 1:
        raise UnsupportedGeometry(f"stride {stride}")
    Hl, Wl, cin = x.shape
    cout = cin if depthwise else w.shape[3]
    out_h, out_w = shard_out_shape(Hl, Wl, K, stride, pads)
    if out_h <= 0 or out_w <= 0 or cin <= 0 or cout <= 0:
        raise UnsupportedGeometry(
            f"degenerate output {out_h}x{out_w}x{cout} for input "
            f"{Hl}x{Wl}x{cin}, k={K}, s={stride}, pads={pads}")
    want = (K, K, 1, cin) if depthwise else (K, K, cin, cout)
    if tuple(w.shape) != want:
        raise ValueError(f"weight shape {tuple(w.shape)} != {want} for "
                         f"input channels {cin}")
    if min(pads) < 0:
        raise ValueError(f"negative pads {pads}")
    if on_cpu(x, w):
        return conv2d_shard_ref(x, w, pads=pads, stride=stride,
                                depthwise=depthwise)
    if x.stride(2) != 1:
        raise RuntimeError(f"conv2d_shard needs channel stride 1, got "
                           f"strides {x.stride()}")
    out = torch.empty((out_h, out_w, cout), dtype=torch.float32,
                      device=x.device)
    lib = build.load("conv2d_shard")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    pt, _, pl_, _ = pads
    sxh, sxw, _ = x.stride()
    swh, sww, swi, swo = w.stride()
    if depthwise:
        rc = lib.conv2d_shard_dw_f32(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), Hl, Wl, cin, K,
            stride, pt, pl_, out_h, out_w, sxh, sxw, swh, sww, swo, stream)
    else:
        ws, ws_ptr, tail = gemm.launch_args(x, w, out_h * out_w, cout,
                                            K * K * cin, cin)
        rc = lib.conv2d_shard_dense_f32(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), ws_ptr, Hl, Wl, cin,
            cout, K, stride, pt, pl_, out_h, out_w, sxh, sxw, swh, sww, swi,
            swo, *tail, stream)
    if rc != 0:
        raise RuntimeError(f"conv2d_shard launch failed: cudaError {rc}")
    conv2d_shard.launches += 1
    return out


conv2d_shard.launches = 0


def conv2d_tiled(x: torch.Tensor, w: torch.Tensor, *, padding: int = 0,
                 stride: int = 1) -> torch.Tensor:
    """Full-tensor convenience form: x [H, W, Cin] unpadded, symmetric
    ``padding``.  Thin wrapper over :func:`conv2d_shard` (a one-shard
    "plan"); kept as the reference's public name."""
    return conv2d_shard(x, w, pads=(padding,) * 4, stride=stride)
