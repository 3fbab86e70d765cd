"""Attention kernels for the H100: paged decode and flash attention.

:func:`flash_decode_paged` is the port of the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_decode_paged``: single-query
attention over a paged KV cache, the attention of every decode step.
:func:`flash_attention_bh` is the port of ``flash_attention_bh``: causal
and/or sliding-window attention over ``[BH, S, hd]``; the model-layout
wrapper with GQA heads is :func:`repro_torch.kernels.ops.flash_attention`.
Both keep the reference's signatures less the TPU tiling (``block_q``,
``block_k``, ``interpret``): each kernel picks its own tiles.

Dispatch is by device, as for the shard kernels
(:mod:`repro_torch.kernels.conv2d`).  CPU tensors run the plain versions
(:func:`~repro_torch.kernels.ref.flash_decode_paged_ref`,
:func:`~repro_torch.kernels.ref.flash_attention_ref`).  CUDA tensors launch
the hand-written kernels in ``csrc/flash_decode_paged.cu`` and
``csrc/flash_attention.cu`` or raise: a wrong device or dtype is a
``TypeError``; a non-contiguous operand, an unsupported head dim and a
failed build or launch are a ``RuntimeError``.  Both take float32 or
bfloat16 (f32 accumulation, output in the input dtype), and neither copies
a grouped-query KV head: ``flash_attention_bh`` reads one KV head for its
``H / KV`` query heads by index, and ``flash_decode_paged``'s grouped
route (``groups > 1``) gives one block the query rows of one pool row, so
each live key and value is fetched once for all of them.
``flash_decode_paged.launches`` and ``flash_attention_bh.launches`` count
kernel launches; ``flash_decode_paged.routes`` counts the decode launches
by route (``per_row``: ``groups = 1``; ``grouped``).

The paged decode kernel's launch shape is chosen here, on the host, so the
CPU tests reach it: :func:`decode_shape` gives a call's split count
(a block of query rows' splits one cluster), block width and query rows a
block, from :func:`decode_splits` and :func:`decode_warps` for the per-row
route and :func:`decode_group_rows` and :func:`decode_grouped_splits` for
the grouped one; :func:`decode_vec` chooses the load width.  Split ``s``
reads the live keys of logical pages ``s * P .. (s + 1) * P - 1``, ``P =
ceil(n_logical / splits)``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..launch import op_cost
from . import build
from .conv2d import on_cpu
from .gemm import SMS
from .ref import (NEG_INF, flash_attention_ref, flash_decode_paged_ref,
                  live_pages)

__all__ = ["NEG_INF", "flash_decode_paged", "flash_attention_bh"]

#: the largest head dim the kernels take (registers and shared memory)
MAX_HEAD_DIM = 256
#: the most splits of a head: one split a block, the splits of a head one
#: thread-block cluster, and 16 blocks is the largest cluster an H100
#: schedules (non-portable above 8)
MAX_SPLITS = 16
#: splits of at most this many keys take a block of 8 warps; longer ones
#: a block of 32 warps, which keeps more rows in flight on its SM
NARROW_KEYS = 64
#: the grouped route's blocks: 8 warps (32 would hold 64 registers a
#: thread, too few for several query rows' state), two to an SM
GROUPED_WARPS = 8
#: the query rows a grouped block holds, by instance
GROUP_ROWS = (2, 4)
#: tables of at most this many keys make latency-bound grouped calls
#: (the served decode's 32): blocks of the fewest query rows and one split,
#: whose block writes its rows with no cluster merge
GROUPED_SHORT_KEYS = 64
#: the grouped route's target of blocks a launch on longer tables: three
#: quarters of two blocks an SM, so every cluster of the launch is resident
#: at once (one wave)
GROUPED_BLOCKS = 3 * SMS // 2


class DecodeShape(NamedTuple):
    """A paged decode launch: ``splits`` of the page table (a cluster of
    blocks), ``warps`` a block, ``group_rows`` query rows a block (1: the
    per-row route)."""
    splits: int
    warps: int
    group_rows: int


def _need_contiguous(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise RuntimeError(f"{name} needs contiguous operands, got "
                               f"shape {tuple(t.shape)} strides "
                               f"{t.stride()}")


def _check_window(window: Optional[int]) -> None:
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def decode_splits(bh: int, n_logical: int) -> int:
    """Splits of each head's page table in one ``flash_decode_paged``
    launch: as many as keep the ``bh x splits`` blocks within half the
    card's SMs (so every head's cluster is resident at once), at most
    :data:`MAX_SPLITS` and one a page, then as few as cut the table into
    runs of the same whole number of pages.  It depends on the head count and the table's length (the
    cache's capacity in pages), never on ``kv_len``: one launch shape
    serves every position of a decode."""
    if bh < 1 or n_logical < 1:
        return 1
    want = max(1, min(MAX_SPLITS, n_logical, SMS // 2 // bh))
    pages = -(-n_logical // want)
    return -(-n_logical // pages)


def decode_warps(n_logical: int, page_size: int, splits: int) -> int:
    """Warps of each block: 8 where a split holds at most
    :data:`NARROW_KEYS` keys, else 32."""
    keys = -(-n_logical // splits) * page_size
    return 8 if keys <= NARROW_KEYS else 32


def decode_group_rows(groups: int, keys: int) -> int:
    """Query rows of one grouped block on a table of ``keys`` keys: 1 (the
    per-row route) for ``groups = 1``; the fewest (:data:`GROUP_ROWS`) on a
    short table or where they hold all ``groups``, else the most; a pool
    row's rows then take ``ceil(groups / rows)`` blocks, the last one
    partly idle."""
    if groups <= 1:
        return 1
    few, most = GROUP_ROWS[0], GROUP_ROWS[-1]
    return few if groups <= few or keys <= GROUPED_SHORT_KEYS else most


def decode_grouped_splits(blocks: int, n_logical: int, keys: int) -> int:
    """Splits of each grouped block's page table: one on a table of at most
    :data:`GROUPED_SHORT_KEYS` keys; else as many as keep the ``blocks x
    splits`` blocks within :data:`GROUPED_BLOCKS`, at most
    :data:`MAX_SPLITS` and one a page, then as few as cut the table into
    runs of the same whole number of pages."""
    if blocks < 1 or n_logical < 1 or keys <= GROUPED_SHORT_KEYS:
        return 1
    want = max(1, min(MAX_SPLITS, n_logical, GROUPED_BLOCKS // blocks))
    pages = -(-n_logical // want)
    return -(-n_logical // pages)


def decode_shape(rows: int, groups: int, n_logical: int,
                 page_size: int) -> DecodeShape:
    """The launch shape of a call on ``rows`` pool rows of ``groups`` query
    rows each, behind a table of ``n_logical`` pages of ``page_size`` keys.
    ``groups = 1``: the per-row route, one block a query row
    (:func:`decode_splits`, :func:`decode_warps`).  ``groups > 1``: the
    grouped route, blocks of :data:`GROUPED_WARPS` warps holding
    :func:`decode_group_rows` query rows each, split by
    :func:`decode_grouped_splits`.  Never a function of ``kv_len``: one
    launch shape serves every position of a decode.  The head dim and the
    dtype do not move it: the sweep that chose these rules (``python -m
    repro_torch.kernels.decode_sweep``) found the best grouped shapes set
    by the blocks and clusters the card holds at once (one wave), not by
    the bytes of a row."""
    if groups <= 1:
        splits = decode_splits(rows, n_logical)
        return DecodeShape(splits, decode_warps(n_logical, page_size, splits),
                           1)
    keys = n_logical * page_size
    gr = decode_group_rows(groups, keys)
    blocks = rows * -(-groups // gr)
    return DecodeShape(decode_grouped_splits(blocks, n_logical, keys),
                       GROUPED_WARPS, gr)


def decode_vec(hd: int, *pools: torch.Tensor) -> bool:
    """Whether the kernel reads K/V rows 16 bytes a lane: a row of ``hd``
    elements is a whole number of 16-byte pieces (``hd % 4 == 0`` in f32,
    ``hd % 8 == 0`` in bf16) and every pool 16-byte aligned (else one
    element a lane).  The CUDA entry point re-checks it and refuses a launch
    that breaks it."""
    return all((hd * p.element_size()) % 16 == 0 and p.data_ptr() % 16 == 0
               for p in pools)


def flash_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table, kv_len, *,
                       window: Optional[int] = None,
                       scale: Optional[float] = None,
                       groups: int = 1) -> torch.Tensor:
    """Decode-step (``q_len == 1``) attention over a paged KV cache.

    ``q``: [BH, hd]; ``k_pages``/``v_pages``: [BH / groups, n_phys_pages,
    page_size, hd] physical page pool, pool row ``bh // groups`` serving
    query row ``bh`` (grouped-query heads, never repeated: on the card a
    ``groups > 1`` call takes the grouped route, whose blocks each hold
    several query rows of one pool row and read its live keys once for
    them, or raises; ``groups=1`` is the reference's signature and the
    per-row route); ``page_table``:
    [n_logical_pages] int32 mapping logical page ``i`` (keys ``i*ps .. (i+1)*ps - 1``) to its
    physical slot — on the card an int32 CUDA tensor on the pools' device
    (the cache keeps one), on the CPU any int sequence; ``kv_len``: number
    of live keys.  Pages outside the live range (past ``ceil(kv_len/ps)``,
    or before the page holding the window's first key) are never read.

    ``kv_len`` is an ``int``, checked against the table here, or a
    one-element int32 tensor on the pools' device, which the kernel reads
    from device memory (the reference's traced ``kv_len``): nothing here
    reads its value, so the call needs no host sync and one captured
    launch serves every position.  The kernel clamps its reads to the
    table, so a device ``kv_len`` past the table reads no page past it;
    the caller bounds it (``PagedKVCache.advance`` does).

    Under the dry run's op counter (:mod:`repro_torch.launch.op_cost`)
    the call is one unit of counted work, made or run there.
    """
    counter = op_cost.active()
    if counter is not None:
        return counter.decode(_flash_decode_paged, q, k_pages, v_pages,
                              page_table, kv_len, window=window,
                              scale=scale, groups=groups)
    return _flash_decode_paged(q, k_pages, v_pages, page_table, kv_len,
                               window=window, scale=scale, groups=groups)


def _flash_decode_paged(q, k_pages, v_pages, page_table, kv_len, *,
                        window, scale, groups):
    rows, _, ps, hd = k_pages.shape
    if groups < 1:
        raise ValueError(f"groups must be >= 1, got {groups}")
    bh = rows * groups
    if tuple(q.shape) != (bh, hd) or v_pages.shape != k_pages.shape:
        raise ValueError(f"decode shapes q {tuple(q.shape)}, pools "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, "
                         f"groups {groups}")
    _check_window(window)
    on_device = isinstance(kv_len, torch.Tensor)
    if on_device:
        if kv_len.dtype != torch.int32 or kv_len.numel() != 1 \
                or kv_len.device != q.device:
            raise TypeError(f"a tensor kv_len is one int32 on the pools' "
                            f"device {q.device}, got {kv_len.dtype} of "
                            f"{kv_len.numel()} on {kv_len.device}")
    else:
        kv_len = int(kv_len)
        _, hi = live_pages(kv_len, ps, window)
        if kv_len < 0 or hi > len(page_table):
            raise ValueError(f"kv_len {kv_len} outside the "
                             f"{len(page_table)} pages of {ps} keys in the "
                             f"table")
    scale = 1.0 / math.sqrt(hd) if scale is None else float(scale)
    if on_cpu(q, k_pages, v_pages, dtypes=(torch.float32, torch.bfloat16)):
        return flash_decode_paged_ref(q, k_pages, v_pages, page_table,
                                      kv_len, window=window, scale=scale,
                                      groups=groups)
    if not (isinstance(page_table, torch.Tensor)
            and page_table.device == q.device
            and page_table.dtype == torch.int32):
        raise TypeError("flash_decode_paged on the card takes the page "
                        "table as an int32 tensor on the pools' device")
    _need_contiguous("flash_decode_paged", q, k_pages, v_pages, page_table)
    if hd > MAX_HEAD_DIM:
        raise RuntimeError(f"flash_decode_paged takes hd <= {MAX_HEAD_DIM}, "
                           f"got {hd}")
    out = torch.empty((bh, hd), dtype=q.dtype, device=q.device)
    if bh == 0:
        return out
    lib = build.load("flash_decode_paged")
    fn = (lib.flash_decode_paged_f32 if q.dtype == torch.float32
          else lib.flash_decode_paged_bf16)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    n_logical = len(page_table)
    shape = decode_shape(rows, groups, n_logical, ps)
    rc = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), out.data_ptr(), bh, k_pages.shape[1],
        n_logical, ps, hd, 0 if on_device else kv_len,
        kv_len.data_ptr() if on_device else None,
        -1 if window is None else int(window),
        shape.splits, shape.warps, int(decode_vec(hd, k_pages, v_pages)),
        groups, shape.group_rows, scale, stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode_paged launch failed: cudaError "
                           f"{rc}")
    flash_decode_paged.launches += 1
    flash_decode_paged.routes[
        "per_row" if shape.group_rows == 1 else "grouped"] += 1
    return out


flash_decode_paged.launches = 0
flash_decode_paged.routes = {"per_row": 0, "grouped": 0}


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, window: Optional[int], scale: Optional[float],
              return_lse: bool = False):
    """The flash attention kernel on the model layout: ``q`` [B, H, S, hd],
    ``k``/``v`` [B, KV, S, hd] with ``H % KV == 0`` (GQA by index, no
    repeated copy).  With ``return_lse`` it returns ``(out, lse)``, ``lse``
    f32 [B, H, S] each query row's log-sum-exp of its masked ``scale q k``
    scores (natural log), which the flash backward recomputes the weights
    from; without it only ``out``, whose bits do not depend on the flag.
    The one place :data:`flash_attention_bh.launches` counts;
    :func:`flash_attention_bh` and ``ops.flash_attention`` call it.  Under
    the dry run's op counter (:mod:`repro_torch.launch.op_cost`) the call
    is one unit of counted work, made or run there."""
    counter = op_cost.active()
    if counter is not None:
        return counter.attention(_attention, q, k, v, causal=causal,
                                 window=window, scale=scale,
                                 return_lse=return_lse)
    return _attention(q, k, v, causal=causal, window=window, scale=scale,
                      return_lse=return_lse)


def _attention(q, k, v, *, causal, window, scale, return_lse):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"attention shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, H, S, hd = q.shape
    KV = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, S, hd) or KV < 1 \
            or H % KV:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (need H % KV == 0)")
    _check_window(window)
    scale = 1.0 / math.sqrt(hd) if scale is None else float(scale)
    dtypes = (torch.float32, torch.bfloat16)
    if on_cpu(q, k, v, dtypes=dtypes):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale, return_lse=return_lse)
    _need_contiguous("flash_attention_bh", q, k, v)
    if hd > MAX_HEAD_DIM:
        raise RuntimeError(f"flash_attention_bh takes hd <= {MAX_HEAD_DIM}, "
                           f"got {hd}")
    if B * H > 65535:
        raise RuntimeError(f"flash_attention_bh takes B*H <= 65535, got "
                           f"{B * H}")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if q.numel() == 0:
        return (out, lse) if return_lse else out
    lib = build.load("flash_attention")
    fn = (lib.flash_attention_f32 if q.dtype == torch.float32
          else lib.flash_attention_bf16)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None, B, H, KV, S, hd,
            int(causal), -1 if window is None else int(window), scale,
            stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bh launch failed: cudaError "
                           f"{rc}")
    flash_attention_bh.launches += 1
    return (out, lse) if return_lse else out


def flash_attention_bh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: Optional[int] = None,
                       scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v: [BH, S, hd], any S (keys at or past S are masked inside the
    kernel; nothing is padded)."""
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_attention_bh takes equal [BH, S, hd] "
                         f"shapes, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    return attention(q[None], k[None], v[None], causal=causal,
                     window=window, scale=scale)[0]


flash_attention_bh.launches = 0
