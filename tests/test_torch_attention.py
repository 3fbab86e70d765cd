"""The port's attention kernels' wrappers against the Pallas kernels.

On the CPU the wrappers run their plain versions, so these tests hold the
dispatch, the shape rules and the plain arithmetic against the JAX
package's ``flash_decode_paged`` and ``flash_attention`` run in interpret
mode, on the reference's own grids and tolerances (tests/test_decode.py
:78-101, tests/test_kernels.py:22-62 and 148-181).  The CUDA kernels are
held against the plain versions on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import \
    flash_attention_bh as j_flash_attention_bh
from repro.kernels.flash_attention import \
    flash_decode_paged as j_flash_decode_paged
from repro.kernels.ops import flash_attention as j_flash_attention
from repro.kernels.ref import attention_ref as j_attention_ref

from repro_torch.kernels import NEG_INF, ops
from repro_torch.kernels.flash_attention import (flash_attention_bh,
                                                 flash_decode_paged)
from repro_torch.kernels.ref import live_pages


def _max_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _paged_case(kv_len, window, ps=4, n_pages=5, BH=3, hd=8):
    """tests/test_decode.py's decode grid inputs: contiguous K/V scattered
    into a pool through a scrambled table."""
    rng = np.random.default_rng(kv_len * 31 + (window or 0))
    k = rng.normal(size=(BH, n_pages * ps, hd)).astype(np.float32)
    v = rng.normal(size=(BH, n_pages * ps, hd)).astype(np.float32)
    q = rng.normal(size=(BH, hd)).astype(np.float32)
    table = rng.permutation(n_pages).astype(np.int32)
    kp = np.zeros((BH, n_pages, ps, hd), np.float32)
    vp = np.zeros_like(kp)
    for lp in range(n_pages):
        kp[:, table[lp]] = k[:, lp * ps:(lp + 1) * ps]
        vp[:, table[lp]] = v[:, lp * ps:(lp + 1) * ps]
    return q, kp, vp, table


@pytest.mark.parametrize("window", [None, 6, 2])
@pytest.mark.parametrize("kv_len", [1, 4, 7, 13, 20])
def test_flash_decode_paged_matches_pallas(window, kv_len):
    """Scrambled table, partial last page, windows whose lower bound lands
    mid-page.  The port's pools also hold NaN in every page it must not
    read (past ceil(kv_len/ps) and before the window's page), to show the
    plain version reads only the live pages."""
    q, kp, vp, table = _paged_case(kv_len, window)
    ref = j_flash_decode_paged(jnp.asarray(q), jnp.asarray(kp),
                               jnp.asarray(vp), table, kv_len, window=window)
    lo, hi = live_pages(kv_len, 4, window)
    kt, vt = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    for lp in list(range(lo)) + list(range(hi, len(table))):
        kt[:, table[lp]] = float("nan")
        vt[:, table[lp]] = float("nan")
    for tab in (table, torch.from_numpy(table)):
        out = flash_decode_paged(torch.from_numpy(q), kt, vt, tab, kv_len,
                                 window=window)
        assert out.dtype == torch.float32 and tuple(out.shape) == q.shape
        assert _max_err(out, ref) < 1e-5


@pytest.mark.parametrize("ps,kv_len,window", [(1, 9, None), (1, 9, 3),
                                              (16, 33, None), (16, 40, 21)])
def test_flash_decode_paged_page_sizes(ps, kv_len, window):
    """Page sizes 1 and 16 (the card's decode shapes) against Pallas."""
    n_pages = -(-48 // ps)
    q, kp, vp, table = _paged_case(kv_len, window, ps=ps, n_pages=n_pages,
                                   BH=2, hd=16)
    scale = 0.3
    ref = j_flash_decode_paged(jnp.asarray(q), jnp.asarray(kp),
                               jnp.asarray(vp), table, kv_len, window=window,
                               scale=scale)
    out = flash_decode_paged(torch.from_numpy(q), torch.from_numpy(kp),
                             torch.from_numpy(vp), table, kv_len,
                             window=window, scale=scale)
    assert _max_err(out, ref) < 1e-5


def test_live_pages_floor_the_window_to_its_page():
    assert live_pages(20, 4) == (0, 5)
    assert live_pages(13, 4, 6) == (1, 4)     # first live key 7, page 1
    assert live_pages(13, 4, 100) == (0, 4)
    assert live_pages(16, 16, 1) == (0, 1)
    assert live_pages(17, 16, 1) == (1, 2)
    assert live_pages(0, 4) == (0, 0)


def test_decode_wrapper_rules():
    q, kp, vp, table = _paged_case(7, None)
    qt, kt, vt = map(torch.from_numpy, (q, kp, vp))
    assert float(flash_decode_paged(qt, kt, vt, table, 0).abs().max()) == 0
    with pytest.raises(ValueError, match="outside"):
        flash_decode_paged(qt, kt, vt, table, 21)
    with pytest.raises(ValueError, match="outside"):
        flash_decode_paged(qt, kt, vt, table[:1], 7)
    with pytest.raises(ValueError, match="window"):
        flash_decode_paged(qt, kt, vt, table, 7, window=0)
    with pytest.raises(ValueError, match="decode shapes"):
        flash_decode_paged(qt[:2], kt, vt, table, 7)
    with pytest.raises(TypeError):
        flash_decode_paged(qt, kt.to("meta"), vt, table, 7)
    assert NEG_INF == -1e30


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _qkv(shape_q, shape_kv, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(dtype)
                 for s in (shape_q, shape_kv, shape_kv))


#: tests/test_kernels.py::test_flash_attention_sweep (shapes x masks), plus
#: the unaligned causal cases of its padding tests
SWEEP = [(B, H, KV, S, hd, causal, window)
         for B, H, KV, S, hd in [(2, 4, 2, 256, 64), (1, 2, 2, 384, 128),
                                 (2, 2, 1, 128, 64), (1, 8, 8, 512, 64)]
         for causal, window in [(True, None), (True, 64), (False, None)]]
SWEEP += [(1, 2, 2, 300, 64, True, 48), (1, 2, 2, 130, 64, True, 40),
          (1, 2, 2, 257, 64, True, 40)]


@pytest.mark.parametrize("B,H,KV,S,hd,causal,window", SWEEP)
def test_ops_flash_attention_matches_pallas(B, H, KV, S, hd, causal,
                                            window):
    q, k, v = _qkv((B, H, S, hd), (B, KV, S, hd), S + hd + H)
    ref = j_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, window=window)
    out = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window)
    assert tuple(out.shape) == q.shape and out.dtype == torch.float32
    assert _max_err(out, ref) < 2e-5


def test_ops_flash_attention_bf16_matches_pallas():
    q, k, v = _qkv((2, 4, 256, 64), (2, 4, 256, 64), 3)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = j_flash_attention(jq, jk, jv, causal=True)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    # same bf16 inputs on both sides
    assert np.array_equal(tq.float().numpy(),
                          np.asarray(jq.astype(jnp.float32)))
    out = ops.flash_attention(tq, tk, tv, causal=True)
    assert out.dtype == torch.bfloat16
    assert _max_err(out.float(), np.asarray(ref.astype(jnp.float32))) < 2e-2


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, None), (False, 96)])
@pytest.mark.parametrize("BH,S,hd,bq,bk", [
    (4, 256, 64, 128, 128),
    (2, 256, 32, 64, 128),
    (2, 384, 64, 128, 64),
    (1, 128, 128, 32, 32),
])
def test_flash_attention_bh_matches_pallas(BH, S, hd, bq, bk, causal,
                                           window):
    """tests/test_kernels.py::test_flash_attention_bh_conformance: the
    Pallas kernel at its block shapes, the port at its own tiles."""
    q, k, v = _qkv((BH, S, hd), (BH, S, hd), BH * S + hd)
    scale = 1.0 / math.sqrt(hd)
    ref = j_flash_attention_bh(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, window=window,
                               scale=scale, block_q=bq, block_k=bk)
    out = flash_attention_bh(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal,
                             window=window, scale=scale)
    assert _max_err(out, ref) < 2e-5


@pytest.mark.parametrize("window", [None, 30])
def test_non_causal_unaligned_against_attention_ref(window):
    """Non-causal attention at S = 100, off every block multiple.  Held
    against ``attention_ref``, not the JAX wrapper: the reference's
    ``ops.flash_attention`` pads S with zero keys that its non-causal
    kernel does not mask (ROADMAP.md, queue C).  The port masks keys at or
    past S, so it needs no padding."""
    q, k, v = _qkv((1, 2, 100, 64), (1, 2, 100, 64), 100)
    ref = j_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=False, window=window)
    out = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=False,
                              window=window)
    assert _max_err(out, ref) < 2e-5


def test_attention_wrapper_rules():
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="H % KV"):
        ops.flash_attention(q, torch.zeros(1, 3, 8, 16),
                            torch.zeros(1, 3, 8, 16))
    with pytest.raises(ValueError, match="do not fit"):
        ops.flash_attention(q, torch.zeros(1, 2, 9, 16),
                            torch.zeros(1, 2, 9, 16))
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, q, q, window=0)
    with pytest.raises(ValueError, match="BH, S, hd"):
        flash_attention_bh(q[0], q[0, :2], q[0])
    with pytest.raises(TypeError):
        flash_attention_bh(q[0], q[0].to("meta"), q[0])
