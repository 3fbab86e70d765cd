"""Host side of the shared implicit-GEMM tile loop (``csrc/gemm_f32.cuh``:
f32, bf16 or fp16 operands, f32 sums) behind :func:`~repro_torch.kernels.
conv2d.conv2d_shard` (dense) and :func:`~repro_torch.kernels.ops.
matmul_tiled`.

Per call it picks the loop, the block tile, the split of the K loop and
the load width of each operand, all from shapes, strides, pointers and
element types:

* :func:`mma_pair` — the loop: the tensor-core loop (``mma.sync`` on bf16
  or fp16 fragments, f32 accumulators) where x and w share one 2-byte
  dtype, the CUDA-core loop (every element read as f32, f32 FMAs) for
  f32 and the mixed pairs (a 2-byte x with f32 weights).  Rounding an f32
  weight to 2 bytes would change the function, so the mixed pairs stay
  on CUDA cores; f32 stays there too (TF32 cannot meet the reference's
  1e-4).
* :func:`plan_gemm` — one of the loop's :data:`CONFIGS` by M (rows of the
  product: a shard's output pixels, an FC shard's rows), then as many K
  chunks as fit in the config's number of waves over the card's
  :data:`SMS` SMs, each chunk a whole number of slabs.  The configs and
  their wave counts come from sweeping every config and split on an H100
  (``python -m repro_torch.kernels.gemm_sweep``; results in PERF.md).
* :func:`x_vec` / :func:`w_vec` — whether 16-byte copies are legal for the
  activations (along channels) and the weight (along output channels): 4
  elements a copy in f32, 8 in a 2-byte dtype.
* :func:`workspace` — the ``[splits, M, N]`` f32 buffer of the split-K
  partial tiles, or ``None`` for one split.
* :func:`launch_args` — all of the above for one call, as the C entry
  points take them, and the route the call takes.

The CUDA launcher re-checks the same conditions and refuses a launch that
breaks them (a tensor-core config for f32 or a mixed pair among them), so
a wrong choice here raises rather than faults.
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
    ``bk``, ``kg`` groups of 128 threads splitting each slab's depth; the
    grid aims for ``waves`` blocks per SM.  ``mma``: the tensor-core loop,
    ``tm`` then being the m16 fragments a warp holds along M; else the
    CUDA-core loop, ``tm`` the rows of a thread's ``tm x 4`` register
    tile."""
    index: int
    bm: int
    bk: int
    tm: int
    kg: int
    waves: float
    mma: bool = False
    bn = 64

    @property
    def route(self) -> str:
        """The name the wrappers count this config's launches under."""
        return "tensor_cores" if self.mma else "cuda_cores"


#: must match gemm_f32::launch in csrc/gemm_f32.cuh
CONFIGS = (
    # the CUDA-core loop: f32 and the mixed pairs
    # conv shards with many output pixels: one wave, the split costs
    # [splits, M, N] of workspace traffic
    TileConfig(0, 32, 32, 4, 4, 1),
    # bert's 32-row FC shards, the late convs' few pixels: the weight
    # streams, three waves keep enough of it in flight
    TileConfig(1, 32, 32, 4, 2, 3),
    # classifier heads (M = 1): GEMV, one slab per block
    TileConfig(2, 8, 32, 1, 4, 3),
    # the tensor-core loop, x and w in one 2-byte dtype: 32-row tiles for
    # every M above 16 (on conv shards of hundreds of pixels they matched
    # or beat 64- and 16-row ones in the sweep), 64-deep slabs, about 1.5
    # waves (more blocks than the CUDA-core loop's one wave of the pixel
    # shards, fewer than its three of the FC shards: a tensor-core block
    # does its slab's products in a few instructions)
    TileConfig(3, 32, 64, 2, 2, 1.5, mma=True),
    # M <= 16 (the classifier heads, the late conv shards of 7-14
    # pixels), where a 32-row tile is half zero or more: 16-row tiles; in
    # the sweep they beat the 32-row tile there at the same split (a
    # 14-pixel 3x3 512->512 shard) and the CUDA-core GEMV tile on the
    # heads
    TileConfig(4, 16, 64, 1, 2, 1.5, mma=True),
)
PIXELS, SKINNY, GEMV, MMA32, MMA16 = CONFIGS


def configs_for(mma: bool) -> Tuple[TileConfig, ...]:
    """The configs the launcher takes for a same-type 2-byte pair
    (``mma``: the tensor-core loop's) or for f32 and the mixed pairs (the
    CUDA-core loop's)."""
    return tuple(c for c in CONFIGS if c.mma == mma)


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
def plan_gemm(m: int, n: int, kdim: int, mma: bool = False) -> GemmPlan:
    """Tile config (by M, on the tensor-core loop where ``mma``) and K
    split of an ``[m, kdim] @ [kdim, n]`` product: as many K chunks (at
    most :data:`MAX_SPLITS`) as fit in the config's number of waves over
    the card's :data:`SMS` SMs.

    On the tensor cores a block's slab costs a few instructions, so a
    split pays only where the tiles alone leave the card idle: with 16
    tiles or more, a chunk keeps at least two slabs (a conv shard of 840
    pixels and K 128 ran fastest unsplit).

    Every call of more than one chunk, on either loop, sums its chunks'
    f32 partial tiles through a workspace (:func:`workspace`) and the
    kernel's second pass."""
    if min(m, n, kdim) <= 0:
        raise ValueError(f"empty product {m}x{kdim} @ {kdim}x{n}")
    if mma:
        cfg = MMA16 if m <= MMA16.bm else MMA32
    else:
        cfg = GEMV if m <= GEMV.bm else SKINNY if m <= SKINNY.bm else PIXELS
    tiles = _cdiv(m, cfg.bm) * _cdiv(n, cfg.bn)
    want = min(MAX_SPLITS, int(cfg.waves * SMS) // tiles)
    if mma:
        slabs = _cdiv(kdim, cfg.bk)
        want = min(want, slabs if tiles < 16 else max(1, slabs // 2))
    return split_plan(cfg, m, n, kdim, want)


def mma_pair(x: torch.Tensor, w: torch.Tensor) -> bool:
    """True where the tensor-core loop computes ``x @ w``: both in one
    2-byte dtype (bf16 or fp16)."""
    return x.dtype == w.dtype and x.element_size() == 2


def vec_elems(t: torch.Tensor) -> int:
    """Elements of ``t``'s dtype in one 16-byte copy: 4 in f32, 8 in bf16
    or fp16."""
    return 16 // t.element_size()


def x_vec(x: torch.Tensor, cin: int) -> bool:
    """16-byte activation copies: ``v`` = :func:`vec_elems` channels of one
    tap, so ``cin % v == 0``, a 16-byte aligned pointer and the other
    strides multiples of ``v``."""
    v = vec_elems(x)
    return (cin % v == 0 and x.data_ptr() % 16 == 0
            and all(s % v == 0 for s in x.stride()[:-1]))


def w_vec(w: torch.Tensor) -> bool:
    """16-byte weight copies along output channels: unit output-channel
    stride, a 16-byte aligned pointer, the other strides multiples of
    :func:`vec_elems`."""
    v = vec_elems(w)
    return (w.stride(-1) == 1 and w.data_ptr() % 16 == 0
            and all(s % v == 0 for s in w.stride()[:-1]))


def workspace(plan: GemmPlan, m: int, n: int,
              device: torch.device) -> Optional[torch.Tensor]:
    """The split-K partial tiles, ``[splits, m, n]`` f32 whatever the
    operands' dtype, or None for one split."""
    if plan.splits == 1:
        return None
    return torch.empty((plan.splits, m, n), dtype=torch.float32,
                       device=device)


def launch_args(x: torch.Tensor, w: torch.Tensor, m: int, n: int,
                kdim: int, cin: int
                ) -> Tuple[Optional[torch.Tensor], int, Tuple[int, ...], str]:
    """What one call of the tile loop needs beside its geometry: the
    workspace (kept alive by the caller until the launch is queued), its
    pointer (0 for none), the trailing ``cfg, splits, kchunk, avec,
    bvec`` arguments of the C entry points, and the route the wrapper
    counts the launch under (:attr:`TileConfig.route`)."""
    plan = plan_gemm(m, n, kdim, mma_pair(x, w))
    ws = workspace(plan, m, n, x.device)
    return ws, 0 if ws is None else ws.data_ptr(), (
        plan.cfg.index, plan.splits, plan.kchunk, int(x_vec(x, cin)),
        int(w_vec(w))), plan.cfg.route
