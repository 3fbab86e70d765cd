"""Seeded weights, made by the benchmark on the device: one draw of
standard normals for the whole set, in the type the weights are served in,
and each tensor a view of it scaled in place to its own deviation.  The
layout (names, shapes, deviations) is the reference's."""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

#: name -> (shape, standard deviation)
Layout = Mapping[str, Tuple[Tuple[int, ...], float]]


def draw(layout: Layout, seed: int, dtype: torch.dtype,
         device) -> Dict[str, torch.Tensor]:
    total = sum(math.prod(shape) for shape, _ in layout.values())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for name, (shape, std) in layout.items():
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul_(std)
        at += n
    return out
