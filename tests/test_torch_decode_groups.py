"""The paged decode kernel's grouped route, held on the CPU.

A call with ``groups > 1`` takes the grouped route of
``csrc/flash_decode_paged.cu`` (``decode_grouped``): one block holds up to
``group_rows`` query rows of one pool row and reads the pool row's live
keys once for all of them.  Its sums run only on the card, so these tests
hold the host side: the launch shape
(:func:`~repro_torch.kernels.flash_attention.decode_shape` and its parts),
the wrapper's launch arguments and route counts through a stand-in
library, the kernel's map from blocks to query rows written out, and a
plain grouped split-and-merge with the kernel's rule against the plain
version and the reference's Pallas kernel in interpret mode on pools
repeated ``groups`` times.  The card tests are in
``tests/test_torch_gpu.py``.
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

from repro_torch.configs.registry import get_config
from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_decode_paged_ref, live_pages

from test_torch_decode_splits import split_keys, split_merge

fa = importlib.import_module("repro_torch.kernels.flash_attention")

#: the registry's grouped-query ratios (query heads over KV heads)
REGISTRY = {"granite-moe-3b-a800m": 3, "llama3-8b": 4, "qwen2.5-14b": 5,
            "qwen2-vl-7b": 7, "qwen2-72b": 8}
GROUPS = (1, 3, 4, 5, 7, 8)
#: (pool rows, pages, page size): the served llama3-8b decode (B 4 x 8 KV
#: heads, 32 keys), its 4096-key call, a prime capacity (pages of 1), one
#: page, a table just past the short ones, a large batch
TABLES = ((32, 2, 16), (32, 256, 16), (8, 17, 1), (4, 1, 10), (8, 5, 16),
          (256, 64, 16))


def test_the_registry_ratios():
    for arch, groups in REGISTRY.items():
        cfg = get_config(arch)
        assert cfg.n_heads // cfg.n_kv == groups, arch


def _edges(splits, pages, ps, capacity):
    out = {0, 1, capacity}
    for s in range(splits + 1):
        e = s * pages * ps
        out |= {e - 1, e, e + 1}
    return sorted(k for k in out if 0 <= k <= capacity)


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("rows,n_logical,ps", TABLES)
def test_every_live_key_falls_in_exactly_one_split(groups, rows, n_logical,
                                                   ps):
    """At the shape each registry ratio gets, for every kv_len at the split
    edges (and 0, 1, capacity) and windows that empty whole splits, the
    splits' key ranges tile the live keys in order, within the cluster
    limit, each inside its own pages and the reference's live pages."""
    shape = fa.decode_shape(rows, groups, n_logical, ps)
    assert 1 <= shape.splits <= min(fa.MAX_SPLITS, n_logical)
    pages = -(-n_logical // shape.splits)
    capacity = n_logical * ps
    for kv_len in _edges(shape.splits, pages, ps, capacity):
        for window in (None, 1, 7, pages * ps, capacity):
            ranges = split_keys(kv_len, ps, n_logical, shape.splits, window)
            first = 0 if window is None else max(0, kv_len - window)
            covered = [k for k0, k1 in ranges if k0 < k1
                       for k in range(k0, k1)]
            assert covered == list(range(first, kv_len)), (kv_len, window)
            lo, hi = live_pages(kv_len, ps, window)
            for s, (k0, k1) in enumerate(ranges):
                if k0 < k1:
                    assert s * pages * ps <= k0 and k1 <= (s + 1) * pages * ps
                    assert lo <= k0 // ps and (k1 - 1) // ps < hi


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("rows,n_logical,ps", TABLES)
def test_grouped_shape(groups, rows, n_logical, ps):
    """A grouped call takes blocks of GROUPED_WARPS warps holding one of
    the instances' row counts, one split on a short table, and on a long
    one as many splits as keep its blocks within GROUPED_BLOCKS (or
    one); every split but the last holds the same whole number of
    pages."""
    shape = fa.decode_shape(rows, groups, n_logical, ps)
    if groups == 1:
        assert shape.group_rows == 1
        return
    keys = n_logical * ps
    assert shape.warps == fa.GROUPED_WARPS
    assert shape.group_rows in fa.GROUP_ROWS
    blocks = rows * -(-groups // shape.group_rows) * shape.splits
    if keys <= fa.GROUPED_SHORT_KEYS:
        assert shape.splits == 1 and shape.group_rows == fa.GROUP_ROWS[0]
    else:
        assert shape.splits == 1 or blocks <= fa.GROUPED_BLOCKS
        assert shape.group_rows == (fa.GROUP_ROWS[0] if groups <= 2
                                    else fa.GROUP_ROWS[-1])
    pages = -(-n_logical // shape.splits)
    assert (shape.splits - 1) * pages < n_logical <= shape.splits * pages


def test_grouped_shape_at_the_lm_shapes():
    """The sweep's picks: the served llama3-8b decode (32 pool rows, 32
    keys) one split of 2-row blocks; llama3-8b at 4096 keys 6 splits of
    4-row blocks (192 blocks); qwen2-72b's 8 groups at 4096 keys two 4-row
    blocks a pool row in 3 splits."""
    assert fa.decode_shape(32, 4, 2, 16) == (1, 8, 2)
    assert fa.decode_shape(32, 4, 256, 16) == (6, 8, 4)
    assert fa.decode_shape(32, 8, 256, 16) == (3, 8, 4)


def test_per_row_choice_is_unchanged():
    """groups = 1 keeps the per-row route's split and width rules, whose
    values at the main path's call and a few others are the ones the
    route had before the grouped route."""
    for rows in (1, 2, 3, 4, 5, 8, 16, 33, 64, 65, 128, 200):
        for n_logical in (1, 2, 7, 16, 32, 100, 256, 4096):
            for ps in (1, 16):
                splits = fa.decode_splits(rows, n_logical)
                assert fa.decode_shape(rows, 1, n_logical, ps) == (
                    splits, fa.decode_warps(n_logical, ps, splits), 1)
    assert fa.decode_shape(4, 1, 32, 16) == (16, 8, 1)
    assert fa.decode_shape(4, 1, 256, 16) == (16, 32, 1)
    assert fa.decode_shape(16, 1, 256, 16) == (4, 32, 1)
    assert fa.decode_shape(128, 1, 256, 16) == (1, 32, 1)
    assert fa.decode_shape(128, 1, 2, 16) == (1, 8, 1)


def block_rows(rows, groups, gr):
    """The query rows each grouped block holds, as the kernel computes
    them: block y takes pool row y // ceil(groups / gr) and its query rows
    g0 .. g0 + nq - 1, g0 = gr * (y % ceil(groups / gr)), nq = min(gr,
    groups - g0)."""
    per_row = -(-groups // gr)
    out = []
    for y in range(rows * per_row):
        prow = y // per_row
        g0 = (y - prow * per_row) * gr
        nq = min(gr, groups - g0)
        out.append((prow, [prow * groups + g0 + g for g in range(nq)]))
    return out


@pytest.mark.parametrize("groups", [2, 3, 4, 5, 6, 7, 8, 9, 16])
@pytest.mark.parametrize("gr", fa.GROUP_ROWS)
def test_blocks_hold_every_query_row_once(groups, gr):
    """Every query row is in exactly one block, with its own pool row
    (row // groups), and a block holds between 1 and gr rows."""
    rows = 3
    seen = []
    for prow, qrows in block_rows(rows, groups, gr):
        assert 1 <= len(qrows) <= gr
        assert all(r // groups == prow for r in qrows)
        seen += qrows
    assert sorted(seen) == list(range(rows * groups))


def _stub_launches(monkeypatch):
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
    return calls


@pytest.mark.parametrize("arch,groups", sorted(REGISTRY.items()))
@pytest.mark.parametrize("cap", [32, 4096])
def test_wrapper_launches_the_grouped_route(monkeypatch, arch, groups, cap):
    """The CUDA branch of the wrapper, with a stand-in library, at a
    registry ratio: every call passes the grouped shape (never the per-row
    route's one row a block), the same one for every kv_len, by value or
    by pointer; each call counts one launch and one grouped route."""
    calls = _stub_launches(monkeypatch)
    rows, ps, hd = 8, 16, 128
    q = torch.zeros(rows * groups, hd)
    kp = torch.zeros(rows, cap // ps, ps, hd)
    table = torch.arange(cap // ps, dtype=torch.int32)
    n0 = fa.flash_decode_paged.launches
    r0 = dict(fa.flash_decode_paged.routes)
    lengths = [1, cap // 3, cap, torch.tensor([7], dtype=torch.int32)]
    for kv_len in lengths:
        fa.flash_decode_paged(q, kp, kp, table, kv_len, groups=groups)
    assert fa.flash_decode_paged.launches - n0 == len(lengths)
    assert fa.flash_decode_paged.routes["grouped"] - r0["grouped"] == \
        len(lengths)
    assert fa.flash_decode_paged.routes["per_row"] == r0["per_row"]
    want = len(build.SIGNATURES["flash_decode_paged"]
               ["flash_decode_paged_f32"])
    shapes = set()
    for args in calls:
        assert len(args) == want
        bh, splits, warps, vec, g, gr = (args[5], *args[13:18])
        assert bh == rows * groups and g == groups and vec == 1
        shapes.add((splits, warps, gr))
    assert shapes == {tuple(fa.decode_shape(rows, groups, cap // ps, ps))}
    (splits, warps, gr), = shapes
    assert gr in fa.GROUP_ROWS and warps == fa.GROUPED_WARPS


def test_grouped_constants_match_the_cuda_source():
    """The grouped route's block width and row counts are the ones the
    CUDA entry point accepts (check_call and pick)."""
    src = (build.CSRC / "flash_decode_paged.cu").read_text()
    assert int(re.search(r"constexpr int GROUPED_WARPS = (\d+);",
                         src).group(1)) == fa.GROUPED_WARPS
    assert int(re.search(r"constexpr int MAX_GROUP_ROWS = (\d+);",
                         src).group(1)) == max(fa.GROUP_ROWS)
    check = src[src.index("cudaError_t check_call("):]
    check = check[:check.index("\n}\n")]
    accepted = {int(v) for v in re.findall(r"gr != (\d+)", check)}
    accepted |= {max(fa.GROUP_ROWS)} if "gr != MAX_GROUP_ROWS" in check \
        else set()
    assert accepted == {1, *fa.GROUP_ROWS}
    cases = src[src.index("cudaError_t pick(const Call& call"):]
    cases = cases[:cases.index("\n}\n")]
    picked = {int(v) for v in re.findall(r"Grouped<(\d+)>", cases)}
    assert picked | {max(fa.GROUP_ROWS)} == set(fa.GROUP_ROWS)


def grouped_split_merge(q, kp, vp, table, kv_len, window, scale, splits,
                        groups, gr):
    """The grouped kernel's rule written out: block by block (a pool row's
    ``gr`` query rows), each split's state of those rows over the split's
    keys, merged in split order (:func:`split_merge` on the block's rows
    and its pool row)."""
    rows = kp.shape[0]
    out = torch.zeros_like(q)
    for prow, qrows in block_rows(rows, groups, gr):
        out[qrows] = split_merge(q[qrows], kp[prow:prow + 1].expand(
            len(qrows), *kp.shape[1:]), vp[prow:prow + 1].expand(
            len(qrows), *vp.shape[1:]), table, kv_len, window, scale,
            splits)
    return out


@pytest.mark.parametrize("groups,ps,n_pages,kv_len,window", [
    (4, 16, 2, 17, None),         # the served decode: one split
    (4, 16, 2, 32, 5),
    (3, 16, 64, 1000, None),      # granite: 4-row blocks, one row idle
    (8, 16, 64, 777, 100),        # qwen2-72b: two blocks a pool row
    (5, 4, 20, 57, None),         # qwen2.5-14b, uneven last split
    (7, 1, 70, 70, 9),            # qwen2-vl-7b, pages of 1
])
def test_grouped_split_merge_matches_plain_and_pallas(groups, ps, n_pages,
                                                      kv_len, window):
    """The grouped rule at the chooser's shape equals the plain grouped
    version and the reference's Pallas kernel (interpret mode) on pools
    repeated ``groups`` times within 1e-5; NaN in every page outside the
    live range is never read."""
    rows, hd = 2, 32
    rng = np.random.default_rng(groups * 100 + kv_len)
    q = rng.normal(size=(rows * groups, hd)).astype(np.float32)
    kp = rng.normal(size=(rows, n_pages, ps, hd)).astype(np.float32)
    vp = rng.normal(size=(rows, n_pages, ps, hd)).astype(np.float32)
    table = rng.permutation(n_pages).astype(np.int32)
    scale = hd ** -0.5
    shape = fa.decode_shape(rows, groups, n_pages, ps)
    assert shape.group_rows > 1
    ref_j = j_flash_decode_paged(
        jnp.asarray(q), jnp.asarray(np.repeat(kp, groups, axis=0)),
        jnp.asarray(np.repeat(vp, groups, axis=0)), table, kv_len,
        window=window, scale=scale)
    qt, kt, vt = map(torch.from_numpy, (q, kp, vp))
    ref_t = flash_decode_paged_ref(qt, kt, vt, table, kv_len, window=window,
                                   scale=scale, groups=groups)
    lo, hi = live_pages(kv_len, ps, window)
    kn, vn = kt.clone(), vt.clone()
    for lp in list(range(lo)) + list(range(hi, n_pages)):
        kn[:, table[lp]] = float("nan")
        vn[:, table[lp]] = float("nan")
    out = grouped_split_merge(qt, kn, vn, table, kv_len, window, scale,
                              shape.splits, groups, shape.group_rows)
    assert bool(torch.isfinite(out).all())
    assert float((out - ref_t).abs().max()) < 1e-5
    assert float(np.abs(out.numpy() - np.asarray(ref_j)).max()) < 1e-5
    assert float(np.abs(ref_t.numpy() - np.asarray(ref_j)).max()) < 1e-5
