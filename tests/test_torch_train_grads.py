"""Gradients of the port's training path against the JAX package's, on CPU
tensors: the self-attention's autograd Function and the SSM blocks.

``FlashSDPA`` (the plain forward with its log-sum-exp, then the port of
``_flash_bwd``) is held against ``jax.vjp`` of the two functions the
reference's ``gqa_full`` differentiates: ``_sdpa`` below
``CHUNKED_SEQ_THRESHOLD`` (S 16) and the ``custom_vjp`` ``_chunked_sdpa``
from it on (S 2048); causal, window 64 and non-causal; KV heads equal to
the query heads, 2 and 1; f32 and bf16.  Then ``gqa_full`` whole (x and
the four projections), the plain log-sum-exp against the reference's
``_flash_fwd_core``, and Mamba2 and RWKV-6 gradients in their exact and
chunked forms (``tests/test_ssm_chunked.py::test_chunked_gradients_match``'s
cases) against the reference and against each other.  Inputs and
cotangents come from numpy.  Tolerances: f32 1e-4 of the reference's scale,
bf16 2e-2 (the reference's two bounds; sums run in other orders, and in
bf16 the products round at other places).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import ssm as JS

from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import attention as A
from repro_torch.models import ssm as S

from test_torch_ssm import _blocks, _cfgs, _x
from torch_lm_cases import (BF16_TOL, F32_TOL, configs,  # noqa: F401
                            one_intra_op_thread, rel_err)

B, H, HD = 1, 4, 16
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}
MASKS = {"causal": (True, None), "window64": (True, 64),
         "noncausal": (False, None)}


def _qkv(S_, kv, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S_, HD)).astype(np.float32)
    k = rng.standard_normal((B, kv, S_, HD)).astype(np.float32)
    v = rng.standard_normal((B, kv, S_, HD)).astype(np.float32)
    dout = rng.standard_normal((B, H, S_, HD)).astype(np.float32)
    return q, k, v, dout


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _reference(q, k, v, dout, causal, window, jdt):
    """(out, dq, dk, dv) of the reference's attention on q [B,H,S,hd] in
    the grouped layout, as gqa_full calls it: ``_sdpa`` below the
    threshold, ``_chunked_sdpa`` from it on."""
    S_ = q.shape[2]
    kv = k.shape[1]
    scale = 1.0 / math.sqrt(HD)
    pos = jnp.broadcast_to(jnp.arange(S_)[None], (B, S_))

    def f(q, k, v):
        qg = q.reshape(B, kv, H // kv, S_, HD)
        if S_ >= JA.CHUNKED_SEQ_THRESHOLD:
            out = JA._chunked_sdpa(qg, k, v, pos, pos, window, scale, causal)
        else:
            mask = None
            if causal:
                mask = JA._causal_window_mask(pos, pos, window)[
                    :, None, None]
            out = JA._sdpa(qg, k, v, mask, scale)
        return out.reshape(B, H, S_, HD)
    @jax.jit
    def fwd_bwd(q, k, v, dout):
        out, vjp = jax.vjp(f, q, k, v)
        return (out, *vjp(dout))
    return [_f32(a) for a in fwd_bwd(*(jnp.asarray(a, jdt)
                                       for a in (q, k, v, dout)))]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kv", [H, 2, 1])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("S_", [16, 2048])
def test_flash_function_grads_match_reference(S_, mask, kv, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    causal, window = MASKS[mask]
    q, k, v, dout = _qkv(S_, kv)
    want = _reference(q, k, v, dout, causal, window, jdt)
    ts = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    out = A.FlashSDPA.apply(*ts, causal, window, 1.0 / math.sqrt(HD), True)
    got = [out, *torch.autograd.grad(out, ts, torch.from_numpy(dout).to(
        tdt))]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.dtype == tdt
        assert rel_err(g.detach(), w) < tol, name


@pytest.mark.parametrize("S_", [16, 2048])
@pytest.mark.parametrize("mask", list(MASKS))
def test_function_equals_autograd_of_the_plain_forward(S_, mask):
    """The chunked backward is the gradient of the plain forward (f32)."""
    causal, window = MASKS[mask]
    q, k, v, dout = _qkv(S_, 2, seed=1)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    g = torch.from_numpy(dout)
    out = A.FlashSDPA.apply(*ts, causal, window, 0.25, True)
    got = torch.autograd.grad(out, ts, g)
    plain = flash_attention_ref(*ts, causal=causal, window=window,
                                scale=0.25)
    want = torch.autograd.grad(plain, ts, g)
    assert torch.equal(out, plain)
    for a, b in zip(got, want):
        assert rel_err(a, b.numpy()) < F32_TOL


def test_function_under_no_grad_saves_nothing():
    """gqa_full passes ``torch.is_grad_enabled()``: under ``no_grad`` the
    Function builds no graph and asks for no log-sum-exp."""
    q, k, v, _ = _qkv(16, 2)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    asked = []
    kernel = A.flash_attention_kernel

    def spy(*args, **kw):
        asked.append(kw.get("return_lse", False))
        return kernel(*args, **kw)
    A.flash_attention_kernel = spy
    try:
        with torch.no_grad():
            o = A.FlashSDPA.apply(*ts, True, None, 0.25,
                                  torch.is_grad_enabled())
        o2 = A.FlashSDPA.apply(*ts, True, None, 0.25,
                               torch.is_grad_enabled())
    finally:
        A.flash_attention_kernel = kernel
    assert o.grad_fn is None and not o.requires_grad
    assert o2.grad_fn is not None and asked == [False, True]
    assert torch.equal(o, o2.detach())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("kv", [H, 1])
def test_plain_lse_matches_reference_flash_fwd_core(mask, kv, dtype):
    """f32 within 1e-4; bf16 within 2e-2 (the reference's bf16 product
    rounds each score to bf16, the plain version scores in f32)."""
    jdt, tdt, tol = DTYPES[dtype]
    causal, window = MASKS[mask]
    S_ = 600                        # two chunks, the second part padded
    q, k, v, _ = _qkv(S_, kv, seed=2)
    pos = jnp.broadcast_to(jnp.arange(S_)[None], (B, S_))
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    _, lse = JA._flash_fwd_core(jq.reshape(B, kv, H // kv, S_, HD), jk, jv,
                                pos, pos, window, 0.25, causal)
    _, got = flash_attention_ref(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal,
        window=window, scale=0.25, return_lse=True)
    assert got.dtype == torch.float32 and got.shape == (B, H, S_)
    assert rel_err(got, np.asarray(lse).reshape(B, H, S_)) < tol


def test_plain_output_bits_do_not_depend_on_lse():
    q, k, v, _ = _qkv(40, 2)
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    a = flash_attention_ref(*args, causal=True, window=8, scale=0.3)
    b, _ = flash_attention_ref(*args, causal=True, window=8, scale=0.3,
                               return_lse=True)
    assert torch.equal(a, b)


@pytest.mark.parametrize("S_", [16, 2048])
@pytest.mark.parametrize("arch,n_kv", [("llama3-8b", 2), ("llama3-8b", 1),
                                       ("olmo-1b", None)])
def test_gqa_full_grads_match_reference(arch, n_kv, S_):
    """The whole self-attention block: gradients of x and of wq, wk, wv,
    wo (f32) through the port's gqa_full and the reference's."""
    kw = {"n_kv": n_kv} if n_kv else {}
    jc, pc = configs(arch, d_model=64, **kw)
    rng = np.random.default_rng(3)
    names = ("wq", "wk", "wv", "wo")
    shapes = {"wq": (64, jc.n_heads * jc.hd), "wk": (64, jc.n_kv * jc.hd),
              "wv": (64, jc.n_kv * jc.hd), "wo": (jc.n_heads * jc.hd, 64)}
    w = {n: (rng.standard_normal(shapes[n]) / 8).astype(np.float32)
         for n in names}
    x = rng.standard_normal((1, S_, 64)).astype(np.float32)
    dy = rng.standard_normal((1, S_, 64)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(S_)[None], (1, S_))

    def jf(x, p):
        return JA.gqa_full(jc, p, x, causal=True, pos=pos,
                           window=jc.attn_window)
    _, vjp = jax.vjp(jf, jnp.asarray(x), {n: jnp.asarray(a)
                                          for n, a in w.items()})
    jdx, jdw = vjp(jnp.asarray(dy))

    p = A.Attention(pc, "cpu", torch.float32)
    with torch.no_grad():
        for n in names:
            getattr(p, n).copy_(torch.from_numpy(w[n]))
    p.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_()
    y = A.gqa_full(pc, p, tx, causal=True,
                   pos=torch.arange(S_)[None].expand(1, S_),
                   window=pc.attn_window)
    grads = torch.autograd.grad(y, [tx, *(getattr(p, n) for n in names)],
                                torch.from_numpy(dy))
    assert rel_err(grads[0], jdx) < F32_TOL
    for n, g in zip(names, grads[1:]):
        assert rel_err(g, jdw[n]) < F32_TOL, n


# ---------------------------------------------------------------------------
# SSM gradients (the reference's test_chunked_gradients_match cases)
# ---------------------------------------------------------------------------

SSM_FWD = {"rwkv6": (JS.rwkv6_time_mix, S.rwkv6_time_mix),
           "mamba2": (JS.mamba2_full, S.mamba2_full)}


def _ssm_grads(kind, chunk, x):
    """(reference, port) gradients of sum(fwd(x)^2) by x and every block
    parameter, the block's form given by ``chunk`` (0: the exact
    recurrence)."""
    jc, pc = _cfgs(kind, chunk)
    p, mod = _blocks(kind)
    jfwd, tfwd = SSM_FWD[kind]
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    jgx, jgp = jax.grad(lambda xx, pp: (jfwd(jc, pp, xx) ** 2).sum(),
                        argnums=(0, 1))(jnp.asarray(x), jp)
    mod.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_()
    names = [n for n, _ in mod.named_parameters()]
    out = tfwd(pc, mod, tx)
    ps = [tx, *(getattr(mod, n) for n in names)]
    # RWKV-6's channel-mix weights are not in the time mix: zeros, as
    # jax.grad gives
    gs = [torch.zeros_like(p) if g is None else g for p, g in zip(
        ps, torch.autograd.grad((out ** 2).sum(), ps, allow_unused=True))]
    want = {"x": np.asarray(jgx), **{n: np.asarray(jgp[n]) for n in names}}
    got = {"x": gs[0], **dict(zip(names, gs[1:]))}
    return want, got


@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("kind", ["rwkv6", "mamba2"])
def test_ssm_grads_match_reference(kind, chunk):
    x = _x(40, seed=4)
    want, got = _ssm_grads(kind, chunk, x)
    assert set(want) == set(got)
    for n in want:
        assert rel_err(got[n], want[n]) < F32_TOL, n


@pytest.mark.parametrize("kind", ["rwkv6", "mamba2"])
def test_ssm_chunked_grads_match_exact(kind):
    """The port's chunked form against its own exact recurrence, as the
    reference holds its two forms (1e-4 absolute on x's gradient)."""
    x = _x(40, seed=5)
    _, exact = _ssm_grads(kind, 0, x)
    _, chunked = _ssm_grads(kind, 16, x)
    assert float((exact["x"] - chunked["x"]).abs().max()) < 1e-4
    for n in exact:
        assert rel_err(chunked[n], exact[n].numpy()) < F32_TOL, n
