"""The dry run's op counter: FLOPs, bytes and live memory of one step,
counted from the torch side (the counterpart of the JAX package's
``launch/hlo_cost.py``, redesigned).

The reference compiles the sharded step with XLA and walks the optimized
HLO (``HloCostAnalyzer``): a ``while`` body times its trip count, a fusion
one kernel, a dot its contraction.  PyTorch has no HLO, so
:class:`OpCounter` is a ``TorchDispatchMode`` that sees every ATen op the
step runs, under ``FakeTensorMode`` (shapes only: a full-width step costs
no memory) or on real tensors (the same ops, run):

* **FLOPs.** ``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot`` and
  ``convolution`` by their exact formulas (2 per multiply-add); every
  other op that computes one FLOP per output element, as ``hlo_cost``
  counts a fusion's elementwise work; copies, concatenations, gathers and
  factories none.
* **Bytes.** Each op its tensor operands plus its results.  Views,
  aliases, metadata queries and ``empty`` allocations count nothing (the
  reference's ``_SKIP_BYTES``).  An in-place write into a slice counts
  the slice: ``copy_`` into a view reads the source and writes the view;
  ``index_put_``, ``index_copy_``, ``index_add_`` and ``scatter_`` read
  and write the update and read the indices, never the whole buffer (the
  reference's ``dynamic-update-slice`` rule); likewise a read of rows by
  index (``index``, ``index_select``, ``embedding``, ``gather``) counts
  the rows it reads and writes and the indices, not the whole source (an
  embedding lookup reads B x S rows of the table).  Other in-place ops
  read and write ``self``; ``fill_`` and ``zero_`` only write it.
* **The kernels.** Each call of ``kernels.flash_attention.attention`` (the
  flash kernel, ``flash_attention_bh``) and ``flash_decode_paged`` is one
  unit of analytic work, never the ops of a plain version: attention
  ``4 B H pairs hd`` FLOPs over the (query, key) pairs its causal and
  window masks leave, bytes q, k, v, out (and the f32 lse when written);
  decode ``4 rows kv hd`` FLOPs over the live keys, bytes q, out, the
  live pages of K and V and the live table entries.  The wrappers hand
  each call to the active counter (:func:`active`): on fake tensors it
  makes the outputs' shapes, on real ones the kernel (or, on the CPU, the
  plain version) runs with the counter looking away.
* **Loops.** The SSM blocks' Python time loops (the reference's
  ``lax.scan``) run four iterations under a counter whose ``fold_loops``
  is on (:func:`time_loop`): the first, one standing for S - 3 middle
  ones (its counts multiplied by S - 3), and the last two.  Every iteration has
  the same shapes, so the count is exact (the counterpart of
  ``known_trip_count``).  Under autograd the fold covers the backward too:
  each folded iteration's autograd nodes are known by their sequence
  numbers, and whatever a node runs in the backward (its gradient and the
  adds that sum it into an input's gradient) counts times its iteration's
  multiplier (:func:`torch._C._current_autograd_node`).  The first and the
  last iteration are run for real because their backward differs from a
  middle one's: the first reads a state that needs no gradient, the last
  writes a state nothing reads.  So is the one before the last: an
  input's gradient is summed in the order the backward reaches the steps,
  last first, and the first gradient to arrive is stored, not added; when
  the last step gives none (the decay that only updates the state), it is
  this step's.  :func:`unfold` stretches the per-step
  outputs back to S without summing S - 2 gradients into the middle one,
  and a remat recompute in the backward folds its loop the same way (its
  ops count by the loop's own multipliers, not the node that set it off).
  So a folded count equals the count of every step run (``fold_loops=
  False``) in FLOPs, bytes and kernel units; ``peak_bytes`` is lower, since
  fewer steps' tensors live.  On real tensors the later steps' outputs are
  then the first ones': a count, not a result.
* **Data-dependent sizes.** ``nonzero`` and indexing by a boolean mask
  (MoE's capacity drop) on fake tensors give their largest result, every
  element kept; on real tensors, what the data keeps.
* **Per device.** The dry run registers its argument leaves with the
  share of their bytes one card moves (:meth:`OpCounter.argument`);
  every other tensor (an intermediate) counts at its global size over
  ``chips``, and every FLOP over ``chips``: the SPMD ideal.  XLA's
  replicated small ops and its fusions (which keep intermediates out of
  HBM) are not modelled.
* **Memory.** ``peak_bytes`` is the largest total of live intermediate
  storage (arguments excluded) at any op boundary, tracked through weak
  references to each result's storage.

The hooks are read through the dispatch-mode stack, which autograd
carries into its backward threads, so a remat recompute in the backward
is counted like the forward.
"""
from __future__ import annotations

import contextlib
from bisect import bisect_right
from typing import Dict, Optional

import numpy as np
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

__all__ = ["OpCounter", "active", "attention_pairs", "time_loop",
           "unfold"]

aten = torch.ops.aten

#: ops that move or make no data (besides views, which ``is_view`` marks)
_SKIP = {
    aten.detach, aten.alias, aten.lift_fresh, aten._unsafe_view,
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
    aten.new_empty_strided, aten.sym_size, aten.sym_stride, aten.sym_numel,
    aten.sym_storage_offset, aten.is_same_size, aten._local_scalar_dense,
    aten.set_, aten.resize_, aten.is_nonzero, aten.equal,
}
#: data movement and factories: bytes, no FLOPs
_NO_FLOPS = {
    aten.copy_, aten.clone, aten._to_copy, aten.cat, aten.stack,
    aten.index, aten.index_select, aten.gather, aten.embedding,
    aten.zeros, aten.ones, aten.full, aten.fill_, aten.zero_, aten.arange,
    aten.scalar_tensor, aten.new_zeros, aten.new_ones, aten.new_full,
    aten.zeros_like, aten.ones_like, aten.full_like, aten.repeat,
    aten.expand_copy, aten.lift_fresh_copy, aten.constant_pad_nd,
    aten.index_put, aten.index_put_, aten._index_put_impl_,
    aten.index_copy, aten.index_copy_, aten.scatter, aten.scatter_,
    aten.slice_scatter, aten.select_scatter, aten.repeat_interleave,
    aten.tril, aten.triu, aten.flip, aten.roll, aten.masked_fill,
    aten.masked_fill_, aten.one_hot,
}
#: in-place writes into a slice of ``self``: the update counts, not self
_SLICE_WRITES = {aten.index_put_, aten._index_put_impl_, aten.index_copy_,
                 aten.index_add_, aten.scatter_, aten.scatter_add_}
_WRITE_ONLY = {aten.fill_, aten.zero_}
#: reads of rows by index: the rows count, not the whole source
_GATHERS = {aten.index, aten.index_select, aten.embedding, aten.gather}


def active() -> Optional["OpCounter"]:
    """The counter on the dispatch-mode stack, or None (the usual case,
    which costs one look at an empty stack)."""
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, OpCounter):
            return mode
    return None


def _next_seq() -> int:
    """The sequence number the next autograd node made on this thread
    gets."""
    return torch.autograd._get_sequence_nr()


@contextlib.contextmanager
def time_loop(trips: int):
    """``with time_loop(S) as steps: for t in steps: ...``: yields
    ``range(S)``; under a counter whose ``fold_loops`` is on and ``S > 4``,
    the steps ``0, 1, S - 2, S - 1``, the second counted ``S - 3`` times
    (see the module docstring).  Every iteration of the loop must have the same
    shapes; :func:`unfold` then stretches the per-step outputs back to
    ``S``."""
    c = active()
    if c is None or not c.fold_loops or trips <= 4:
        yield range(trips)
        return
    base = c.mult
    try:
        yield c._folded(trips, base)
    finally:
        c.mult = base


def _join_folded(join, dim: int, trips: int, per_step) -> torch.Tensor:
    """``join`` of a folded loop's four per-step outputs stretched back to
    ``trips`` steps, the second repeated, counted as that one op over
    ``trips`` inputs (one op, as the loop's own join; a fake op over
    thousands of inputs would cost seconds to make)."""
    c = active()
    first = per_step[0]
    c._inside += 1
    try:
        idx = torch.ones((trips,), dtype=torch.long, device=first.device)
        idx[0], idx[-2], idx[-1] = 0, 2, 3
        out = torch.stack(list(per_step), dim).index_select(dim, idx)
        if join is torch.cat:
            out = out.flatten(dim, dim + 1)
    finally:
        c._inside -= 1
    full = [first, *[per_step[1]] * (trips - 3), *per_step[2:]]
    op = aten.cat.default if join is torch.cat else aten.stack.default
    c._count(op, (full, dim), {}, out)
    c._results(out)
    return out


class _Join(torch.autograd.Function):
    """:func:`_join_folded` under autograd.  Its backward hands each
    folded iteration the gradient of one step (a view, as the join's own
    backward gives it), so the repeated middle output gets one step's
    gradient, not the sum of ``trips - 3``."""

    @staticmethod
    def forward(ctx, join, dim, trips, *ys):
        ctx.dim, ctx.trips = dim, trips
        ctx.size = ys[0].shape[dim] if join is torch.cat else None
        return _join_folded(join, dim, trips, ys)

    @staticmethod
    def backward(ctx, g):
        steps = (0, 1, ctx.trips - 2, ctx.trips - 1)
        if ctx.size is None:
            grads = [g.select(ctx.dim, i) for i in steps]
        else:
            grads = [g.narrow(ctx.dim, i * ctx.size, ctx.size)
                     for i in steps]
        return (None, None, None, *grads)


def unfold(per_step: list, trips: int, join=torch.stack,
           dim: int = 0) -> torch.Tensor:
    """``join(outputs, dim)`` of a :func:`time_loop`'s outputs, one per
    step: ``per_step`` itself, or its four folded iterations with the
    second repeated ``trips - 3`` times (``join`` is ``torch.stack`` or
    ``torch.cat``)."""
    if len(per_step) == trips:
        return join(per_step, dim)
    if torch.is_grad_enabled() and any(y.requires_grad for y in per_step):
        return _Join.apply(join, dim, trips, *per_step)
    return _join_folded(join, dim, trips, per_step)


def attention_pairs(S: int, causal: bool, window: Optional[int],
                    Sk: Optional[int] = None) -> int:
    """(query, key) pairs that the causal and window masks leave among
    ``S`` queries and ``Sk`` keys (default ``S``), positions ``0 ..``."""
    Sk = S if Sk is None else Sk
    qi = np.arange(S, dtype=np.int64)
    hi = np.minimum(qi + 1, Sk) if causal else np.full(S, Sk, np.int64)
    lo = np.maximum(0, qi - window + 1) if window is not None else 0
    return int(np.maximum(0, hi - lo).sum())


#: ops whose boolean-mask indices size their result by the data
_MASKED = {aten.index, aten.index_put, aten.index_put_,
           aten._index_put_impl_}


def _all_kept(indices):
    """``indices`` with each boolean mask replaced by the index tensors
    of every element it covers: a data-dependent size at its largest, as
    if the mask kept all (MoE's capacity mask keeps all but its drops)."""
    out = []
    for m in indices:
        if m is None or m.dtype != torch.bool:
            out.append(m)
            continue
        rest, dims = torch.arange(m.numel(), device=m.device), []
        for size in reversed(m.shape):
            dims.append(rest % size)
            rest = rest // size
        out.extend(reversed(dims))
    return out


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts one step's FLOPs, bytes, kernel units and live memory (see
    the module docstring); ``chips`` divides every FLOP and every
    intermediate's bytes.  Use as a context manager around the step."""

    def __init__(self, *, chips: int = 1, fold_loops: bool = True):
        super().__init__()
        self.chips = chips
        self.fold_loops = fold_loops
        self.flops = 0.0
        self.bytes = 0.0
        self.units: Dict[str, int] = {}
        self.ops = 0
        #: op name -> [calls, flops, bytes], for reading a count apart
        self.by_op: Dict[str, list] = {}
        self.relayouts: list = []
        self.mult = 1.0
        #: sequence-number ranges of folded iterations' autograd nodes,
        #: ``(start, end, multiplier)`` in the order they were made
        self._folds: list = []
        self._inside = 0
        self._div: Dict[StorageWeakRef, float] = {}
        self._live: Dict[StorageWeakRef, int] = {}
        self._live_bytes = 0
        self.peak_bytes = 0

    # ---- set-up -------------------------------------------------------
    def argument(self, t: torch.Tensor, divisor: float = 1.0) -> None:
        """Register ``t`` as an argument leaf: not an intermediate, and its
        bytes (and its views') count over ``divisor``."""
        self._div[StorageWeakRef(t.untyped_storage())] = float(divisor)

    def relayout(self, shape, spec) -> None:
        """A re-layout point of the activation-sharding callback."""
        self.relayouts.append((tuple(shape), spec))

    # ---- loop folds ---------------------------------------------------
    def _folded(self, trips: int, base: float):
        """The iterations of a folded :func:`time_loop`: sets the
        multiplier of each and, when autograd records outside a backward
        (not a remat recompute, whose nodes never run), remembers the
        sequence numbers of the nodes the middle one makes."""
        for t, k in ((0, 1), (1, trips - 3), (trips - 2, 1), (trips - 1, 1)):
            self.mult = base * k
            record = (k != 1 and torch.is_grad_enabled()
                      and torch._C._current_autograd_node() is None)
            lo = _next_seq()
            yield t
            if record and _next_seq() > lo:
                self._folds.append((lo, _next_seq(), k))

    def _scale(self) -> float:
        """The multiplier of an op now: the loop's, times that of the
        autograd node running it when that node belongs to a folded
        iteration (in a backward, where grad mode is off; a recompute
        turns it on)."""
        if not self._folds or torch.is_grad_enabled():
            return self.mult
        node = torch._C._current_autograd_node()
        if node is None:
            return self.mult
        seq = node._sequence_nr()
        i = bisect_right(self._folds, seq, key=lambda f: f[0]) - 1
        if i >= 0 and seq < self._folds[i][1]:
            return self.mult * self._folds[i][2]
        return self.mult

    # ---- accounting ---------------------------------------------------
    def _bytes(self, t: torch.Tensor) -> float:
        div = self._div.get(StorageWeakRef(t.untyped_storage()), self.chips)
        return _nbytes(t) / div

    def _sweep(self) -> None:
        for k in [k for k in self._live if k.expired()]:
            self._live_bytes -= self._live.pop(k)

    def _results(self, out) -> None:
        """Track the storages ``out`` brings into being (intermediates)."""
        for t in _tensors(out):
            st = t.untyped_storage()
            key = StorageWeakRef(st)
            if key in self._div:
                continue
            if key in self._live:
                if not key.expired():
                    continue
                self._live_bytes -= self._live.pop(key)
            n = st.nbytes()
            self._live[key] = n
            self._live_bytes += n
        if self._live_bytes > self.peak_bytes:
            self._sweep()
            self.peak_bytes = max(self.peak_bytes, self._live_bytes)

    def add(self, flops: float, nbytes: float, mult: float = 1.0) -> None:
        self.flops += flops * mult / self.chips
        self.bytes += nbytes * mult

    def _count(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        if func.is_view or packet in _SKIP or func.namespace == "prim":
            return
        self.ops += 1
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        outs = list(_tensors(out))
        if packet in _SLICE_WRITES:
            # the indices read; the update read and written into the slice
            upd = ins[1:]
            nbytes = sum(self._bytes(t) for t in upd)
            nbytes += sum(self._bytes(t) for t in upd
                          if t.is_floating_point())
        elif packet in _GATHERS:
            # the rows read and written out, and the indices
            nbytes = 2.0 * sum(self._bytes(t) for t in outs)
            nbytes += sum(self._bytes(t) for t in ins[1:])
        elif packet is aten.copy_:
            nbytes = self._bytes(ins[1]) + self._bytes(ins[0])
        elif packet in _WRITE_ONLY:
            nbytes = self._bytes(ins[0])
        else:
            nbytes = sum(self._bytes(t) for t in ins)
            nbytes += sum(self._bytes(t) for t in outs)
        if packet in (aten.mm, aten.addmm):
            a, b = (ins[0], ins[1]) if packet is aten.mm else (ins[1],
                                                               ins[2])
            flops = 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
        elif packet in (aten.bmm, aten.baddbmm):
            a, b = (ins[0], ins[1]) if packet is aten.bmm else (ins[1],
                                                                ins[2])
            flops = 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
        elif packet in (aten.mv, aten.dot):
            flops = 2.0 * ins[0].numel()
        elif packet in (aten.convolution, aten._convolution):
            w = ins[1]
            flops = 2.0 * outs[0].numel() * (w.numel() // w.shape[0])
        elif packet in _NO_FLOPS:
            flops = 0.0
        else:
            flops = float(sum(t.numel() for t in outs))
        mult = self._scale()
        self.add(flops, nbytes, mult)
        tally = self.by_op.setdefault(str(packet), [0, 0.0, 0.0])
        tally[0] += 1
        tally[1] += flops * mult / self.chips
        tally[2] += nbytes * mult

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is aten.nonzero.default and _is_fake(args[0]):
            x = args[0]
            out = torch.empty((x.numel(), x.dim()), dtype=torch.int64,
                              device=x.device)
        elif func.overloadpacket in _MASKED and any(
                _is_fake(m) and m.dtype == torch.bool
                for m in args[1] if m is not None):
            out = func(args[0], _all_kept(args[1]), *args[2:], **kwargs)
        else:
            out = func(*args, **kwargs)
        if not self._inside:
            self._count(func, args, kwargs, out)
            self._results(out)
        return out

    # ---- kernel units -------------------------------------------------
    def _unit(self, name: str, flops: float, nbytes: float, run, fake):
        mult = self._scale()
        self.units[name] = self.units.get(name, 0) + int(mult)
        self.add(flops, nbytes, mult)
        self._inside += 1
        try:
            out = fake() if fake is not None else run()
        finally:
            self._inside -= 1
        self._results(out)
        return out

    def attention(self, fn, q, k, v, *, causal, window, scale,
                  return_lse=False):
        """One call of the flash kernel ``fn`` (``q`` [B, H, S, hd], ``k``
        and ``v`` [B, KV, S, hd]) as a unit."""
        B, H, S, hd = q.shape
        pairs = attention_pairs(S, causal, window, k.shape[2])
        nbytes = sum(self._bytes(t) for t in (q, k, v))
        nbytes += _nbytes(q) / self.chips
        if return_lse:
            nbytes += 4.0 * B * H * S / self.chips

        def fake():
            out = torch.empty_like(q)
            if not return_lse:
                return out
            return out, torch.empty((B, H, S), dtype=torch.float32,
                                    device=q.device)
        return self._unit(
            "flash_attention_bh", 4.0 * B * H * pairs * hd, nbytes,
            lambda: fn(q, k, v, causal=causal, window=window, scale=scale,
                       return_lse=return_lse),
            fake if _is_fake(q) else None)

    def decode(self, fn, q, k_pages, v_pages, page_table, kv_len, *,
               window, scale, groups):
        """One call of the paged decode kernel ``fn`` as a unit: the live
        keys of ``kv_len`` (all of the table's pages when ``kv_len`` is a
        tensor, whose value the count does not read)."""
        from ..kernels.ref import live_pages
        rows, _, ps, hd = k_pages.shape
        n_pages = len(page_table)
        if isinstance(kv_len, torch.Tensor):
            lo, hi, keys = 0, n_pages, n_pages * ps
        else:
            lo, hi = live_pages(int(kv_len), ps, window)
            keys = int(kv_len) - (max(0, int(kv_len) - window)
                                  if window is not None else 0)
        live = (hi - lo) / k_pages.shape[1]
        nbytes = self._bytes(q) + _nbytes(q) / self.chips
        nbytes += live * (self._bytes(k_pages) + self._bytes(v_pages))
        nbytes += 4.0 * (hi - lo)            # the live int32 table entries
        return self._unit(
            "flash_decode_paged", 4.0 * q.shape[0] * keys * hd, nbytes,
            lambda: fn(q, k_pages, v_pages, page_table, kv_len,
                       window=window, scale=scale, groups=groups),
            (lambda: torch.empty_like(q)) if _is_fake(q) else None)
