"""The controls' lower precisions: each rounds a product's operands as the
hardware would before multiplying them, the sums staying in f32.

* ``tf32``: f32 rounded to nearest-even at 10 mantissa bits, as the
  tensor cores' TF32 mode reads f32 operands (the step below f32 with
  TF32 off);
* ``fp8_e4m3``: each operand scaled by its largest magnitude to the
  format's range (448), rounded to ``float8_e4m3fn`` and scaled back, as
  an fp8 product with per-tensor scales computes (the step below bf16).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

FP8_MAX = 448.0


def tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    bias = 0xFFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


ROUNDINGS = {"tf32": tf32, "fp8_e4m3": fp8_e4m3}


def rounding(name: Optional[str]) -> Optional[Callable]:
    return None if name is None else ROUNDINGS[name]
