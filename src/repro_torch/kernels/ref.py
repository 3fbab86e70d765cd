"""Plain PyTorch versions of the shard kernels (the allclose ground truth).

Each repeats its kernel's arithmetic with plain tensor operations in f32:
the conv shard is a sum over the K*K taps of ``[Ho*Wo, Cin] @ [Cin, Cout]``
products (a broadcast multiply for depthwise), as the TPU kernel computes
it, and the FC shard is one f32 matrix product.  The wrappers in
:mod:`repro_torch.kernels.conv2d` and :mod:`repro_torch.kernels.ops` run
these for tensors that lie on the CPU; on the card they are the versions
the kernels are held against.  Layouts are the engine's: activations
``[H, W, C]``, conv weights HWIO, depthwise weights ``[K, K, 1, C]``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def conv2d_shard_ref(x: torch.Tensor, w: torch.Tensor, *,
                     pads: Tuple[int, int, int, int] = (0, 0, 0, 0),
                     stride: int = 1,
                     depthwise: bool = False) -> torch.Tensor:
    """Shard-layout conv with per-side zero ``pads`` (top, bottom, left,
    right): x ``[Hl, Wl, Cin]``, w ``[K, K, Cin, Cout]`` (depthwise
    ``[K, K, 1, C]``) -> ``[Ho, Wo, Cout]``."""
    pt, pb, pl_, pr = pads
    k = w.shape[0]
    xp = F.pad(x.float(), (0, 0, pl_, pr, pt, pb))
    hp, wp, cin = xp.shape
    ho = max(0, (hp - k) // stride + 1)
    wo = max(0, (wp - k) // stride + 1)
    cout = cin if depthwise else w.shape[3]
    wf = w.float()
    acc = torch.zeros((ho, wo, cout), dtype=torch.float32, device=x.device)
    for kh in range(k):
        for kw in range(k):
            xs = xp[kh:kh + (ho - 1) * stride + 1:stride,
                    kw:kw + (wo - 1) * stride + 1:stride, :]
            if depthwise:
                acc += xs * wf[kh, kw, 0]
            else:
                acc += (xs.reshape(ho * wo, cin) @ wf[kh, kw]).reshape(
                    ho, wo, cout)
    return acc.to(x.dtype)


def conv2d_ref(x: torch.Tensor, w: torch.Tensor, *, padding: int = 0,
               stride: int = 1) -> torch.Tensor:
    """x: [H, W, Cin]; w: [K, K, Cin, Cout], symmetric ``padding``."""
    return conv2d_shard_ref(x, w, pads=(padding,) * 4, stride=stride)


def dwconv2d_ref(x: torch.Tensor, w: torch.Tensor, *, padding: int = 0,
                 stride: int = 1) -> torch.Tensor:
    """Depthwise: x [H, W, C]; w [K, K, 1, C], symmetric ``padding``."""
    return conv2d_shard_ref(x, w, pads=(padding,) * 4, stride=stride,
                            depthwise=True)


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [M, Cin] @ w: [Cin, Cout] in f32 accumulation."""
    return (x.float() @ w.float()).to(x.dtype)
