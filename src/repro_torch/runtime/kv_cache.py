"""Distributed paged KV cache for autoregressive decode, on torch pools.

Pages live on the nodes that own the heads: each (layer, node) keeps its
own physical page pool holding exactly that node's kv heads, so the node
that computes a head's attention is the node whose pool stores that
head's K/V.  One logical→physical page table is shared by every pool:
logical page ``i`` (token positions ``i*page_size .. (i+1)*page_size - 1``)
maps to the physical slot ``page_table[i]``.  Physical slots are assigned
in a seeded scrambled order — the same numpy permutation as the reference
cache's, so both give the same table for the same seed — so every consumer
genuinely goes through the table.

Pool layout is ``[local_heads, n_pages, page_size, head_dim]``, the layout
:func:`repro_torch.kernels.flash_decode_paged` streams.  The pools are
allocated once on ``device``, and writes go in place (the reference's
immutable arrays are updated functionally instead); the table is copied to
the device once per cache (:attr:`PagedKVCache.device_table`).

Two ways to write a token's K/V: :meth:`PagedKVCache.append` resolves the
slot of a host position, and :meth:`PagedKVCache.write` takes the slot
that :meth:`PagedKVCache.slot_index` computes on the device from a device
position, with no host sync, as the decode step does inside its captured
CUDA graph (the reference's ``pool.at[:, phys, row].set(k)`` at a traced
``pos``).  Only :meth:`PagedKVCache.advance` bounds the position then.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["PagedKVCache"]


class PagedKVCache:
    """Paged K/V pools for ``n_layers`` attention layers over ``nodes``
    nodes.

    ``head_split[layer][node]`` is the number of kv heads node ``node``
    owns in ``layer`` (the planner's head-granular OutC split; replicated
    layers list the full head count on every node).  ``capacity`` is the
    maximum token count; storage is ``ceil(capacity / page_size)`` physical
    pages per pool, allocated up front on ``device``.
    """

    def __init__(self, head_split: Sequence[Sequence[int]], head_dim: int,
                 page_size: int, capacity: int, *, seed: int = 0,
                 dtype=torch.float32, device="cuda"):
        if page_size < 1 or capacity < 1:
            raise ValueError(f"bad page geometry ps={page_size}, "
                             f"capacity={capacity}")
        self.head_split: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(int(h) for h in per_node) for per_node in head_split)
        self.n_layers = len(self.head_split)
        self.nodes = len(self.head_split[0]) if self.n_layers else 0
        self.head_dim = int(head_dim)
        self.page_size = int(page_size)
        self.capacity = int(capacity)
        self.n_pages = -(-capacity // page_size)
        self.dtype = dtype
        self.device = torch.device(device)
        # scrambled logical -> physical assignment (deterministic per seed)
        rng = np.random.default_rng(seed)
        self._table = np.asarray(rng.permutation(self.n_pages), np.int32)
        self.device_table = torch.from_numpy(self._table).to(self.device)
        self._k: List[List[torch.Tensor]] = []
        self._v: List[List[torch.Tensor]] = []
        for per_node in self.head_split:
            if len(per_node) != self.nodes:
                raise ValueError("ragged head_split across layers")
            shape = lambda lh: (lh, self.n_pages, self.page_size,
                                self.head_dim)
            self._k.append([torch.zeros(shape(lh), dtype=dtype,
                                        device=self.device)
                            for lh in per_node])
            self._v.append([torch.zeros(shape(lh), dtype=dtype,
                                        device=self.device)
                            for lh in per_node])
        self.length = 0

    # ---- geometry ---------------------------------------------------------
    @property
    def page_table(self) -> np.ndarray:
        """Logical→physical page map, ``[n_pages]`` int32 (host copy)."""
        return self._table

    def slot(self, pos: int) -> Tuple[int, int]:
        """(physical_page, row) of token position ``pos``."""
        if not 0 <= pos < self.capacity:
            raise ValueError(f"position {pos} outside capacity "
                             f"{self.capacity}")
        return int(self._table[pos // self.page_size]), pos % self.page_size

    def bytes_per_node(self, node: int) -> int:
        """Pool bytes resident on ``node`` — proportional to the heads it
        owns, which is the whole point of head-owner page placement."""
        elems = sum(split[node] for split in self.head_split) \
            * self.n_pages * self.page_size * self.head_dim
        return 2 * elems * np.dtype(np.float32).itemsize  # K and V

    # ---- access -----------------------------------------------------------
    def append(self, layer: int, node: int, pos: int, k, v) -> None:
        """Write one token's K/V (``[local_heads, head_dim]``) for
        ``(layer, node)`` at position ``pos``, in place."""
        phys, row = self.slot(pos)
        self._k[layer][node][:, phys, row] = k
        self._v[layer][node][:, phys, row] = v

    def slot_index(self, pos: torch.Tensor) -> torch.Tensor:
        """Flat row ``phys * page_size + row`` of the device position
        ``pos`` (an integer tensor of one element on the cache's device),
        as a ``[1]`` int64 tensor there: ``phys = device_table[pos //
        page_size]``, ``row = pos % page_size``, computed on the device.
        Nothing checks ``pos``: the caller keeps it below the capacity."""
        p = pos.reshape(1).long()
        phys = self.device_table.index_select(0, p // self.page_size)
        return phys.long() * self.page_size + p % self.page_size

    def write(self, layer: int, node: int, slot: torch.Tensor, k,
              v) -> None:
        """Write one token's K/V (``[local_heads, head_dim]``) for
        ``(layer, node)`` at the flat row ``slot`` of :meth:`slot_index`,
        in place, with no host sync."""
        for pool, t in zip(self.pages(layer, node), (k, v)):
            lh = pool.shape[0]
            pool.view(lh, -1, self.head_dim).index_copy_(
                1, slot, t.reshape(lh, 1, self.head_dim))

    def store(self, layer: int, node: int, k_pages, v_pages) -> None:
        """Replace a pool wholesale."""
        exp = tuple(self._k[layer][node].shape)
        if tuple(k_pages.shape) != exp:
            raise ValueError(f"pool shape {tuple(k_pages.shape)} != {exp}")
        self._k[layer][node] = k_pages
        self._v[layer][node] = v_pages

    def pages(self, layer: int, node: int):
        """(k_pages, v_pages) of one pool —
        ``[local_heads, n_pages, page_size, head_dim]``."""
        return self._k[layer][node], self._v[layer][node]

    def advance(self, n: int = 1) -> int:
        """Commit ``n`` appended positions; returns the new length."""
        if self.length + n > self.capacity:
            raise ValueError(f"cache overflow: {self.length}+{n} > "
                             f"capacity {self.capacity}")
        self.length += n
        return self.length

    def gather(self, layer: int, node: int):
        """Contiguous logical-order (K, V) ``[length, local_heads,
        head_dim]`` — debugging / conformance view (gathers by table)."""
        kp, vp = self.pages(layer, node)
        L = self.length
        pages = torch.from_numpy(
            self._table[: -(-L // self.page_size)].astype(np.int64)).to(
                kp.device)
        k = kp[:, pages].reshape(kp.shape[0], -1, self.head_dim)[:, :L]
        v = vp[:, pages].reshape(vp.shape[0], -1, self.head_dim)[:, :L]
        return k.transpose(0, 1), v.transpose(0, 1)
