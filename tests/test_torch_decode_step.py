"""The port's decode step as one program: the step body on device
``pos``/``kv_len`` tensors, the paged decode kernel's tensor ``kv_len``
and the cache's device-index K/V write, against the JAX package.

On the CPU ``DecodeSession._step_fn`` is the body itself, run eagerly,
so these tests hold the very body that the card captures as a CUDA graph
(``test_torch_gpu.py`` holds the capture against it).  Sizes and
tolerances are the reference's (tests/test_decode.py): tokens identical,
logits within rtol = atol = 1e-4; the decode kernel within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import \
    flash_decode_paged as j_flash_decode_paged
from repro.runtime.decode import DecodeSession as JDecodeSession
from repro.runtime.decode import greedy_decode as j_greedy_decode
from repro.runtime.kv_cache import PagedKVCache as JPagedKVCache
from repro.runtime.session import ExecConfig as JExecConfig

from repro_torch import (DecodeSession, ExecConfig, PagedKVCache,
                         transformer_weights_from_numpy)
from repro_torch.kernels.flash_attention import flash_decode_paged
from repro_torch.kernels.ref import (_decode_masked, flash_decode_paged_ref,
                                     live_pages)

from test_torch_decode import J_SPEC, N_NEW, PROMPT, SPEC, _plans, oracle

CPU = ExecConfig(device="cpu")


def _body_decode(sess, prompt, n_new, pos_dtype):
    """greedy_decode through ``sess._local_step`` called directly, with
    the token and the position as tensors (``pos`` 0-d of ``pos_dtype``)."""
    emb = sess.weights["emb"]

    def step(tok):
        pos = torch.tensor(sess.cache.length, dtype=pos_dtype)
        sess.cache.advance(1)
        return sess._local_step(torch.tensor([tok]), pos)

    for tok in prompt:
        h = step(tok)
    tokens, logits = [], []
    for _ in range(n_new):
        lg = h @ emb.T
        tok = int(torch.argmax(lg))
        tokens.append(tok)
        logits.append(lg)
        h = step(tok)
    return tokens, torch.stack(logits)


@pytest.mark.parametrize("pos_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("nodes", [1, 2, 4])
def test_device_pos_body_matches_jax_session_and_oracle(nodes, pos_dtype):
    """The step body on tensor positions, under both backends, gives the
    tokens of the JAX local DecodeSession and of reference_decode, its
    logits within 1e-4 of both, and the JAX session's K/V pools."""
    wj, wnp, ref_toks, ref_lg = oracle()
    pj, pt = _plans(max(nodes, 2))
    sj = JDecodeSession(J_SPEC, wj, pj, nodes, JExecConfig(),
                        page_size=4, capacity=32)
    toks_j, lg_j = j_greedy_decode(sj, PROMPT, N_NEW)
    wt = transformer_weights_from_numpy(wnp, "cpu")
    for backend in ("cuda", "torch"):
        sess = DecodeSession(SPEC, wt, pt, nodes,
                             ExecConfig(backend=backend, device="cpu"),
                             page_size=4, capacity=32)
        assert sess._step_fn == sess._local_step
        toks, lg = _body_decode(sess, PROMPT, N_NEW, pos_dtype)
        assert toks == toks_j == ref_toks, backend
        np.testing.assert_allclose(lg.numpy(), ref_lg, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(lg.numpy(), np.asarray(lg_j), rtol=1e-4,
                                   atol=1e-4)
        for n in range(nodes):
            for a, b in zip(sess.cache.pages(0, n), sj.cache.pages(0, n)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-4, atol=1e-4)


def _pools(rng, bh, n_pages, ps, hd):
    k = rng.standard_normal((bh, n_pages, ps, hd)).astype(np.float32)
    v = rng.standard_normal((bh, n_pages, ps, hd)).astype(np.float32)
    q = rng.standard_normal((bh, hd)).astype(np.float32)
    table = rng.permutation(n_pages).astype(np.int32)
    return q, k, v, table


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("ps", [1, 4])
def test_decode_kernel_takes_a_tensor_kv_len(ps, window):
    """A one-element int32 kv_len gives the int path's bits, and both
    equal the Pallas kernel with a jnp.int32 kv_len in interpret mode
    within 1e-5."""
    rng = np.random.default_rng(ps * 10 + (window or 0))
    n_pages, hd, bh = 24 // ps, 16, 3
    q, k, v, table = _pools(rng, bh, n_pages, ps, hd)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    tt = torch.from_numpy(table)
    for kv_len in (1, ps + 1, 11, 24):
        by_value = flash_decode_paged(qt, kt, vt, tt, kv_len, window=window)
        on_device = flash_decode_paged(
            qt, kt, vt, tt, torch.tensor([kv_len], dtype=torch.int32),
            window=window)
        assert torch.equal(by_value, on_device), kv_len
        ref = j_flash_decode_paged(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(table),
                                   jnp.int32(kv_len), window=window,
                                   interpret=True)
        np.testing.assert_allclose(on_device.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)


def test_decode_kernel_refuses_a_malformed_tensor_kv_len():
    q = torch.zeros(2, 8)
    kp = torch.zeros(2, 4, 2, 8)
    table = torch.arange(4, dtype=torch.int32)
    for bad in (torch.tensor([3]), torch.tensor([3, 4], dtype=torch.int32),
                torch.tensor([3], dtype=torch.int32, device="meta")):
        with pytest.raises(TypeError, match="kv_len"):
            flash_decode_paged(q, kp, kp, table, bad)


@pytest.mark.parametrize("window", [None, 3, 9])
def test_masked_plain_version_equals_the_live_page_gather(window):
    """The plain version's form for a device kv_len (every page gathered,
    dead keys masked) equals its live-page gather within 1e-6, with NaN in
    every page a call must not read."""
    rng = np.random.default_rng(7)
    bh, n_pages, ps, hd = 2, 6, 4, 8
    q, k, v, table = (torch.from_numpy(a)
                      for a in _pools(rng, bh, n_pages, ps, hd))
    for kv_len in (0, 1, 5, 12, 24):
        lo, hi = live_pages(kv_len, ps, window)
        dead = table[[j for j in range(n_pages) if not lo <= j < hi]].long()
        kn, vn = k.clone(), v.clone()
        kn[:, dead] = float("nan")
        vn[:, dead] = float("nan")
        want = flash_decode_paged_ref(q, kn, vn, table, kv_len,
                                      window=window, scale=0.3)
        got = _decode_masked(q, kn, vn, table, torch.tensor(kv_len),
                             window, 0.3)
        assert bool(torch.isfinite(got).all()), kv_len
        assert float((got - want).abs().max()) < 1e-6, kv_len


def test_device_index_write_equals_append():
    """Writing each token at the slot computed on the device from a tensor
    position fills the pools exactly as ``append`` at the host position
    does, and as the JAX cache does."""
    split = [[3, 1], [2, 2]]
    kw = dict(head_dim=4, page_size=3, capacity=14, seed=2)
    by_host = PagedKVCache(split, device="cpu", **kw)
    by_dev = PagedKVCache(split, device="cpu", **kw)
    cj = JPagedKVCache(split, **kw)
    rng = np.random.default_rng(0)
    for pos in range(14):
        slot = by_dev.slot_index(torch.tensor(pos))
        phys, row = by_host.slot(pos)
        assert slot.tolist() == [phys * 3 + row]
        for layer, per_node in enumerate(split):
            for node, lh in enumerate(per_node):
                k = rng.normal(size=(lh, 4)).astype(np.float32)
                kt, vt = torch.from_numpy(k), torch.from_numpy(2 * k)
                by_host.append(layer, node, pos, kt, vt)
                by_dev.write(layer, node, slot, kt, vt)
                cj.append(layer, node, pos, jnp.asarray(k),
                          jnp.asarray(2 * k))
    for layer in range(2):
        for node in range(2):
            for a, b, c in zip(by_dev.pages(layer, node),
                               by_host.pages(layer, node),
                               cj.pages(layer, node)):
                assert torch.equal(a, b)
                assert np.array_equal(a.numpy(), np.asarray(c))


def test_step_checks_the_capacity_and_the_token_before_it_runs():
    """The host check of ``advance`` guards the device position: a step
    past the capacity raises before anything is written, as does a token
    outside the vocabulary."""
    _, wnp, _, _ = oracle()
    wt = transformer_weights_from_numpy(wnp, "cpu")
    sess = DecodeSession(SPEC, wt, _plans(2)[1], 2, CPU, page_size=4,
                         capacity=3)
    with pytest.raises(ValueError, match="vocabulary"):
        sess.step(SPEC.vocab)
    assert sess.cache.length == 0
    h = sess.prefill([3, 17, 42])
    kept = h.clone()
    pools = [t.clone() for t in sess.cache.pages(1, 1)]
    with pytest.raises(ValueError, match="overflow"):
        sess.step(7)
    assert sess.cache.length == 3
    assert torch.equal(h, kept)
    for a, b in zip(sess.cache.pages(1, 1), pools):
        assert torch.equal(a, b)
