"""The paged decode kernel's split-KV launch shape, held on the CPU.

The CUDA kernel (``csrc/flash_decode_paged.cu``) cuts each head's page
table into split runs, one block each, and merges the blocks' online-softmax
states in rank order inside one cluster.  Its index arithmetic and merge run
only on the card, so these tests hold the host side that chooses the shape
(:func:`decode_splits`, :func:`decode_warps`, :func:`decode_vec`), the
key ranges the kernel gives each split (:func:`split_keys`, its index
arithmetic written out), and a plain split-and-merge that repeats the
kernel's merge rule, against ``flash_decode_paged_ref`` and the Pallas
kernel in interpret mode.  The card tests are in ``tests/test_torch_gpu.py``.
"""
import importlib
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import \
    flash_decode_paged as j_flash_decode_paged

from repro_torch.kernels import build
from repro_torch.kernels.ref import (NEG_INF, flash_decode_paged_ref,
                                     live_pages)

fa = importlib.import_module("repro_torch.kernels.flash_attention")

#: the main path's call: 4 heads a node, capacity 512 at page size 16
MAIN_BH, MAIN_PAGES, MAIN_PS = 4, 32, 16


def split_keys(kv_len, page_size, n_logical, splits, window=None):
    """The live keys ``[k0, k1)`` each split reads, as the kernel computes
    them (``k0``/``k1`` in ``csrc/flash_decode_paged.cu``): split ``s``
    owns logical pages ``s * P .. (s + 1) * P - 1``, ``P = ceil(n_logical
    / splits)``, cut to the live keys ``first .. kv_len - 1`` (``first =
    kv_len - window``, 0 without a window).  ``k0 >= k1``: nothing."""
    pages = -(-n_logical // splits)
    first = 0 if window is None else max(0, kv_len - window)
    return [(max(first, s * pages * page_size),
             min(kv_len, min(n_logical, (s + 1) * pages) * page_size))
            for s in range(splits)]


def _edges(splits, pages, ps, capacity):
    """kv_len values at and around every split's first key, plus 0, 1 and
    the capacity."""
    out = {0, 1, capacity}
    for s in range(splits + 1):
        e = s * pages * ps
        out |= {e - 1, e, e + 1}
    return sorted(k for k in out if 0 <= k <= capacity)


@pytest.mark.parametrize("bh,n_logical,ps", [
    (MAIN_BH, MAIN_PAGES, MAIN_PS), (4, 256, 16), (16, 256, 16),
    (3, 40, 1), (1, 1, 16), (2, 9, 1), (5, 100, 4), (64, 32, 16)])
def test_every_live_key_falls_in_exactly_one_split(bh, n_logical, ps):
    """For every kv_len at the split edges (and 0, 1, capacity) and windows
    that empty whole splits, the splits' key ranges tile the live keys
    first .. kv_len - 1 in order, and each lies in its own pages and in the
    reference's live pages lo .. hi - 1."""
    splits = fa.decode_splits(bh, n_logical)
    pages = -(-n_logical // splits)
    capacity = n_logical * ps
    for kv_len in _edges(splits, pages, ps, capacity):
        for window in (None, 1, 7, pages * ps, capacity):
            ranges = split_keys(kv_len, ps, n_logical, splits,
                                          window)
            assert len(ranges) == splits
            first = 0 if window is None else max(0, kv_len - window)
            live = [(k0, k1) for k0, k1 in ranges if k0 < k1]
            covered = [k for k0, k1 in live for k in range(k0, k1)]
            assert covered == list(range(first, kv_len)), (kv_len, window)
            lo, hi = live_pages(kv_len, ps, window)
            for s, (k0, k1) in enumerate(ranges):
                if k0 < k1:
                    assert s * pages * ps <= k0 and k1 <= (s + 1) * pages * ps
                    assert lo <= k0 // ps and (k1 - 1) // ps < hi


def test_splits_depend_on_heads_and_table_length_only():
    """S is a function of (bh, table length): the same for every kv_len of
    a decode, within the cluster limit, at most one split a page, and the
    main path's call gets at least 32 blocks."""
    assert fa.MAX_SPLITS <= 16
    for bh in (1, 2, 3, 4, 5, 8, 16, 33, 64, 65, 200):
        for n_logical in (1, 2, 7, 16, 32, 100, 256, 4096):
            s = fa.decode_splits(bh, n_logical)
            assert 1 <= s <= min(fa.MAX_SPLITS, n_logical)
            assert bh * s <= max(bh, fa.SMS // 2)
            # the same whole number of pages in every split but the last
            pages = -(-n_logical // s)
            assert (s - 1) * pages < n_logical <= s * pages
    assert MAIN_BH * fa.decode_splits(MAIN_BH, MAIN_PAGES) >= 32
    assert fa.decode_splits(0, 32) == fa.decode_splits(4, 0) == 1


def test_block_width_follows_the_split_length():
    assert fa.decode_warps(MAIN_PAGES, MAIN_PS,
                           fa.decode_splits(MAIN_BH, MAIN_PAGES)) == 8
    assert fa.decode_warps(256, 16, fa.decode_splits(4, 256)) == 32
    assert fa.decode_warps(4, 16, 1) == 8            # 64 keys
    assert fa.decode_warps(5, 16, 1) == 32           # 80 keys


def test_load_width_follows_head_dim_and_alignment():
    base = torch.zeros(4 * 2 * 16 * 128 + 1)
    aligned = base[:-1].view(4, 2, 16, 128)
    off = base[1:].view(4, 2, 16, 128)
    assert aligned.data_ptr() % 16 == 0 and off.data_ptr() % 16 != 0
    assert fa.decode_vec(128, aligned, aligned)
    assert not fa.decode_vec(128, aligned, off)
    assert not fa.decode_vec(126, aligned, aligned)


def test_decode_constants_match_the_cuda_source():
    """The host's cluster limit and block widths are the ones the CUDA
    entry point accepts."""
    src = (build.CSRC / "flash_decode_paged.cu").read_text()
    assert int(re.search(r"constexpr int MAX_SPLITS = (\d+);",
                         src).group(1)) == fa.MAX_SPLITS
    widths = {int(w) for w in re.findall(r"warps != (\d+)", src)}
    assert widths == {fa.decode_warps(1, 1, 1), fa.decode_warps(1000, 1, 1)}


def test_wrapper_launch_arguments(monkeypatch):
    """The CUDA branch of the wrapper, run with a stand-in library: the
    arguments match the declared C signature, the split count and block
    width do not move with kv_len, each call counts one launch, and a
    tensor kv_len goes to the kernel as a pointer (by-value argument 0)
    while an int goes by value (null pointer)."""
    calls = []

    class Lib:
        def flash_decode_paged_f32(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(fa, "on_cpu", lambda *a, **k: False)
    monkeypatch.setattr(fa.build, "load", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    q = torch.zeros(MAIN_BH, 128)
    kp = torch.zeros(MAIN_BH, MAIN_PAGES, MAIN_PS, 128)
    table = torch.arange(MAIN_PAGES, dtype=torch.int32)
    n0 = fa.flash_decode_paged.launches
    lengths = [torch.tensor([n], dtype=torch.int32) for n in (1, 300)]
    for kv_len in (1, 17, 300, 512, *lengths):
        fa.flash_decode_paged(q, kp, kp, table, kv_len, window=100)
    assert fa.flash_decode_paged.launches - n0 == 6
    want = len(build.SIGNATURES["flash_decode_paged"]
               ["flash_decode_paged_f32"])
    shapes, by_value, pointers = set(), [], []
    for args in calls:
        assert len(args) == want
        (bh, n_pages, n_logical, ps, hd, kv_len, kv_len_ptr, window, splits,
         warps, vec) = args[5:16]
        assert (bh, n_pages, n_logical, ps, hd, window) == \
            (MAIN_BH, MAIN_PAGES, MAIN_PAGES, MAIN_PS, 128, 100)
        shapes.add((splits, warps, vec))
        by_value.append(kv_len)
        pointers.append(kv_len_ptr)
    assert shapes == {(16, 8, 1)}
    assert by_value == [1, 17, 300, 512, 0, 0]
    assert pointers == [None] * 4 + [t.data_ptr() for t in lengths]


def _paged(rng, bh, n_pages, ps, hd):
    k = rng.normal(size=(bh, n_pages, ps, hd)).astype(np.float32)
    v = rng.normal(size=(bh, n_pages, ps, hd)).astype(np.float32)
    q = rng.normal(size=(bh, hd)).astype(np.float32)
    table = rng.permutation(n_pages).astype(np.int32)
    return q, k, v, table


def split_merge(q, kp, vp, table, kv_len, window, scale, splits):
    """Plain split-and-merge with the kernel's rule: each split's (m, l,
    acc) over its keys, starting from m = NEG_INF, l = 0, acc = 0; then in
    split order the max M, weights exp(m_i - M), and acc / max(l, 1e-30).
    Reads only the keys ``split_keys`` gives."""
    ps = kp.shape[2]
    bh, hd = q.shape
    states = []
    for k0, k1 in split_keys(kv_len, ps, len(table), splits,
                                       window):
        m = torch.full((bh,), NEG_INF, dtype=torch.float32)
        l = torch.zeros(bh)
        acc = torch.zeros(bh, hd)
        if k0 < k1:
            keys = torch.arange(k0, k1)
            phys = torch.as_tensor(table)[keys // ps].long()
            k = kp[:, phys, keys % ps]
            v = vp[:, phys, keys % ps]
            s = torch.einsum("hd,htd->ht", q, k) * scale
            m = s.max(dim=-1).values
            p = torch.exp(s - m[:, None])
            l = p.sum(dim=-1)
            acc = torch.einsum("ht,htd->hd", p, v)
        states.append((m, l, acc))
    mx = torch.stack([m for m, _, _ in states]).max(dim=0).values
    l_all = torch.zeros(bh)
    o = torch.zeros(bh, hd)
    for m, l, acc in states:
        w = torch.exp(m - mx)
        l_all = l_all + l * w
        o = o + acc * w[:, None]
    return o / torch.clamp(l_all, min=1e-30)[:, None]


@pytest.mark.parametrize("ps,n_pages,bh,kv_len,window,splits", [
    (16, MAIN_PAGES, MAIN_BH, 512, None, None),     # main path, full cache
    (16, MAIN_PAGES, MAIN_BH, 33, None, None),      # most splits empty
    (16, MAIN_PAGES, MAIN_BH, 481, 40, None),       # only the last split
    (16, MAIN_PAGES, MAIN_BH, 96, 32, None),        # window on a split edge
    (16, 8, 2, 1, None, 8),                         # kv_len 1
    (1, 40, 3, 40, None, None),                     # page size 1, capacity
    (1, 40, 3, 23, 5, 16),                          # window inside a split
    (4, 20, 2, 57, 100, 7),                         # uneven last split
])
def test_split_merge_matches_plain_and_pallas(ps, n_pages, bh, kv_len,
                                              window, splits):
    """The kernel's merge rule, with its chosen (or a forced) split count
    and empty splits in the merge, equals the plain version and the Pallas
    kernel within 1e-5; NaN in every page outside the live range is never
    read."""
    rng = np.random.default_rng(kv_len * 7 + ps)
    q, kp, vp, table = _paged(rng, bh, n_pages, ps, 32)
    scale = 32 ** -0.5
    splits = splits or fa.decode_splits(bh, n_pages)
    ranges = split_keys(kv_len, ps, n_pages, splits, window)
    if kv_len < n_pages * ps or window is not None:
        assert any(k0 >= k1 for k0, k1 in ranges)     # empty splits merge
    ref_j = j_flash_decode_paged(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), table, kv_len,
                                 window=window, scale=scale)
    qt, kt, vt = map(torch.from_numpy, (q, kp, vp))
    ref_t = flash_decode_paged_ref(qt, kt, vt, table, kv_len, window=window,
                                   scale=scale)
    lo, hi = live_pages(kv_len, ps, window)
    kn, vn = kt.clone(), vt.clone()
    for lp in list(range(lo)) + list(range(hi, n_pages)):
        kn[:, table[lp]] = float("nan")
        vn[:, table[lp]] = float("nan")
    out = split_merge(qt, kn, vn, table, kv_len, window, scale, splits)
    assert bool(torch.isfinite(out).all())
    assert float((out - ref_t).abs().max()) < 1e-5
    assert float(np.abs(out.numpy() - np.asarray(ref_j)).max()) < 1e-5


def test_split_merge_of_only_empty_splits_is_zero():
    """kv_len 0: every split is empty; the merge gives zeros, as the
    reference does, and no NaN."""
    rng = np.random.default_rng(0)
    q, kp, vp, table = _paged(rng, 2, 8, 4, 16)
    out = split_merge(*map(torch.from_numpy, (q, kp, vp)), table, 0, None,
                      0.25, 4)
    assert float(out.abs().max()) == 0.0
