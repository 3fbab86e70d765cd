"""Host side of the shared f32 implicit-GEMM tile loop
(``csrc/gemm_f32.cuh``) behind :func:`~repro_torch.kernels.conv2d.
conv2d_shard` (dense) and :func:`~repro_torch.kernels.ops.matmul_tiled`.

Per call it picks the block tile, the split of the K loop and the load
width of each operand, all from shapes, strides and pointers:

* :func:`plan_gemm` — one of :data:`CONFIGS` by M (rows of the product:
  a shard's output pixels, an FC shard's rows), then as many K chunks as
  fit in the config's number of waves over the card's :data:`SMS` SMs,
  each chunk a whole number of slabs.  The configs and their wave counts
  come from sweeping every config and split on an H100
  (``python -m repro_torch.kernels.gemm_sweep``; results in PERF.md).
* :func:`x_vec` / :func:`w_vec` — whether 16-byte copies are legal for the
  activations (along channels) and the weight (along output channels).
* :func:`workspace` — the ``[splits, M, N]`` f32 buffer of the split-K
  partial tiles, or ``None`` for one split.
* :func:`launch_args` — all of the above for one call, as the C entry
  points take them.

The CUDA launcher re-checks the same conditions and refuses a launch that
breaks them, so a wrong choice here raises rather than faults.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

import torch

#: SMs of an H100 SXM
SMS = 132
#: most K chunks of one call (bounds the workspace and the reduction)
MAX_SPLITS = 32


@dataclass(frozen=True)
class TileConfig:
    """One instantiation of the tile loop: ``index`` is the ``cfg``
    argument of ``gemm_f32::launch``; block tile ``bm x 64``, slab depth
    ``bk``, a ``tm x 4`` register tile per thread, ``kg`` groups of 128
    threads splitting each slab's depth; the grid aims for ``waves``
    blocks per SM."""
    index: int
    bm: int
    bk: int
    tm: int
    kg: int
    waves: int
    bn = 64


#: must match gemm_f32::launch in csrc/gemm_f32.cuh
CONFIGS = (
    # conv shards with many output pixels: one wave, the split costs
    # [splits, M, N] of workspace traffic
    TileConfig(0, 32, 32, 4, 4, 1),
    # bert's 32-row FC shards, the late convs' few pixels: the weight
    # streams, three waves keep enough of it in flight
    TileConfig(1, 32, 32, 4, 2, 3),
    # classifier heads (M = 1): GEMV, one slab per block
    TileConfig(2, 8, 32, 1, 4, 3),
)
PIXELS, SKINNY, GEMV = CONFIGS


@dataclass(frozen=True)
class GemmPlan:
    """Grid of one call: ``m_tiles x n_tiles`` output tiles times
    ``splits`` K chunks; chunk ``s`` sums the flattened K index
    ``[s * kchunk, min(kdim, (s + 1) * kchunk))``."""
    cfg: TileConfig
    m_tiles: int
    n_tiles: int
    splits: int
    kchunk: int

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.n_tiles * self.splits


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(cfg: TileConfig, m: int, n: int, kdim: int,
               splits: int) -> GemmPlan:
    """``cfg``'s grid for an ``[m, kdim] @ [kdim, n]`` product with at
    most ``splits`` K chunks, each a whole number of slabs."""
    slabs = _cdiv(kdim, cfg.bk)
    per = _cdiv(slabs, max(1, min(splits, slabs)))
    return GemmPlan(cfg, _cdiv(m, cfg.bm), _cdiv(n, cfg.bn),
                    _cdiv(slabs, per), per * cfg.bk)


@lru_cache(maxsize=4096)
def plan_gemm(m: int, n: int, kdim: int) -> GemmPlan:
    """Tile config (by M) and K split of an ``[m, kdim] @ [kdim, n]``
    product: as many K chunks (at most :data:`MAX_SPLITS`) as fit in the
    config's number of waves over the card's :data:`SMS` SMs."""
    if min(m, n, kdim) <= 0:
        raise ValueError(f"empty product {m}x{kdim} @ {kdim}x{n}")
    cfg = GEMV if m <= GEMV.bm else SKINNY if m <= SKINNY.bm else PIXELS
    tiles = _cdiv(m, cfg.bm) * _cdiv(n, cfg.bn)
    return split_plan(cfg, m, n, kdim,
                      min(MAX_SPLITS, cfg.waves * SMS // tiles))


def x_vec(x: torch.Tensor, cin: int) -> bool:
    """16-byte activation copies: 4 channels of one tap, so ``cin % 4 ==
    0``, a 16-byte aligned pointer and the other strides multiples of 4."""
    return (cin % 4 == 0 and x.data_ptr() % 16 == 0
            and all(s % 4 == 0 for s in x.stride()[:-1]))


def w_vec(w: torch.Tensor) -> bool:
    """16-byte weight copies along output channels: unit output-channel
    stride, a 16-byte aligned pointer, the other strides multiples of 4."""
    return (w.stride(-1) == 1 and w.data_ptr() % 16 == 0
            and all(s % 4 == 0 for s in w.stride()[:-1]))


def workspace(plan: GemmPlan, m: int, n: int,
              device: torch.device) -> Optional[torch.Tensor]:
    """The split-K partial tiles, ``[splits, m, n]`` f32, or None."""
    if plan.splits == 1:
        return None
    return torch.empty((plan.splits, m, n), dtype=torch.float32,
                       device=device)


def launch_args(x: torch.Tensor, w: torch.Tensor, m: int, n: int,
                kdim: int, cin: int) -> Tuple[Optional[torch.Tensor], int,
                                              Tuple[int, ...]]:
    """What one call of the tile loop needs beside its geometry: the
    workspace (kept alive by the caller until the launch is queued), its
    pointer (0 for none), and the trailing ``cfg, splits, kchunk, avec,
    bvec`` arguments of the C entry points."""
    plan = plan_gemm(m, n, kdim)
    ws = workspace(plan, m, n, x.device)
    return ws, 0 if ws is None else ws.data_ptr(), (
        plan.cfg.index, plan.splits, plan.kchunk, int(x_vec(x, cin)),
        int(w_vec(w)))
