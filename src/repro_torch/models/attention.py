"""Attention blocks: GQA (dense archs), MLA (DeepSeek-V2), cross-attention
(Whisper), with full/prefill and KV-cache decode paths, causal + sliding
window masks, RoPE / M-RoPE: the port of the JAX package's
``models/attention.py``.

The reference computes every attention with jnp (``_sdpa``, and
``_chunked_sdpa`` from ``CHUNKED_SEQ_THRESHOLD`` keys on, the streaming
twin of its Pallas flash kernel).  Here the self-attention of
:func:`gqa_full` (causal, sliding-window or the encoder's non-causal) at
every length goes through the hand-written flash kernel
(``kernels.flash_attention.attention``, grouped heads by index), and every
step of :func:`gqa_decode` through the paged decode kernel
(``flash_decode_paged``), the cache ``[B, KV, cap, hd]`` read in place as
its page pool.  On CPU tensors both wrappers run their plain versions.
Cross-attention (keys from the encoder, another length than the queries)
and MLA stay plain torch, as in the reference, which computes them
outside Pallas: MLA's prefill has a 192-wide qk head over a 128-wide v head
the flash kernel does not take, and its decode attends in the latent space.

Training differentiates the self-attention through :class:`FlashSDPA`,
the port of the reference's ``_chunked_sdpa`` ``custom_vjp``: its forward
is the flash kernel writing its log-sum-exp, its backward
:func:`flash_backward`, the reference's ``_flash_bwd`` (jnp there, plain
torch here).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..kernels.flash_attention import attention as flash_attention_kernel
from ..kernels.flash_attention import flash_decode_paged
from ..kernels.ref import NEG_INF
from .common import _param, apply_mrope, apply_rope

#: the largest page of the decode kernel's view of a cache
PAGE_SIZE = 16
#: keys a chunk of the flash backward (the reference's ``_KV_CHUNK``)
KV_CHUNK = 512


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class Attention(torch.nn.Module):
    """GQA projections ``[d_in, d_out]`` (``x @ w``, the reference's
    layout), with the QKV biases where the config has them."""

    def __init__(self, cfg, device, dtype: torch.dtype):
        super().__init__()
        hd, d = cfg.hd, cfg.d_model
        self.wq = _param((d, cfg.n_heads * hd), device, dtype)
        self.wk = _param((d, cfg.n_kv * hd), device, dtype)
        self.wv = _param((d, cfg.n_kv * hd), device, dtype)
        self.wo = _param((cfg.n_heads * hd, d), device, dtype)
        if cfg.qkv_bias:
            self.bq = _param((cfg.n_heads * hd,), device, dtype)
            self.bk = _param((cfg.n_kv * hd,), device, dtype)
            self.bv = _param((cfg.n_kv * hd,), device, dtype)


class MLA(torch.nn.Module):
    """DeepSeek-V2 latent attention; ``w_uk`` is stored ``[H, qk_nope,
    kv_lora]`` and ``w_uv`` ``[H, kv_lora, v_head]`` for the absorbed
    decode, as in the reference."""

    def __init__(self, cfg, device, dtype: torch.dtype):
        super().__init__()
        m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
        self.w_dq = _param((d, m.q_lora), device, dtype)
        self.w_uq = _param((m.q_lora, H * (m.qk_nope + m.qk_rope)), device,
                           dtype)
        self.w_dkv = _param((d, m.kv_lora), device, dtype)
        self.w_kr = _param((d, m.qk_rope), device, dtype)
        self.w_uk = _param((H, m.qk_nope, m.kv_lora), device, dtype)
        self.w_uv = _param((H, m.kv_lora, m.v_head), device, dtype)
        self.wo = _param((H * m.v_head, d), device, dtype)


# ---------------------------------------------------------------------------
# Plain attention (cross-attention and MLA)
# ---------------------------------------------------------------------------

def _causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                        window: Optional[int]) -> torch.Tensor:
    """[..., Q, K] boolean mask: causal, optionally sliding-window."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        m &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    return m


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """q [B,K,G,Q,hd], k/v [B,K,S,hd] (grouped-query layout).  Dots run in
    the operand dtype; only the scores are upcast for the softmax."""
    scores = torch.einsum("bkgqd,bksd->bkgqs", q, k).float() * scale
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bksd->bkgqd", w, v)


# ---------------------------------------------------------------------------
# Differentiable self-attention: the flash forward and its backward
# ---------------------------------------------------------------------------

def _chunk_valid(k0: int, k1: int, S: int, causal: bool,
                 window: Optional[int], device) -> Optional[torch.Tensor]:
    """[S, k1 - k0] mask of queries 0 .. S-1 against keys k0 .. k1-1 (the
    reference's ``_chunk_valid`` by index, positions being 0 .. S-1); None
    where nothing is masked."""
    if not causal and window is None:
        return None
    qi = torch.arange(S, device=device)[:, None]
    ki = torch.arange(k0, k1, device=device)[None, :]
    valid = torch.ones((S, k1 - k0), dtype=torch.bool, device=device)
    if causal:
        valid &= ki <= qi
    if window is not None:
        valid &= ki > qi - window
    return valid


def flash_backward(q, k, v, out, lse, dout, *, causal: bool,
                   window: Optional[int], scale: float):
    """The reference's ``_flash_bwd`` (``src/repro/models/attention.py``
    :165), line for line: ``D = rowsum(dout * out)`` in f32, then per
    :data:`KV_CHUNK` keys the scores recomputed and masked, ``p = exp(s -
    lse)``, ``dv``, ``dp``, ``ds = p (dp - D) scale`` in q's dtype, ``dq``
    summed in f32 and ``dk``.  ``q``/``out``/``dout`` [B, H, S, hd], ``k``/
    ``v`` [B, KV, S, hd], ``lse`` f32 [B, H, S]; in the grouped layout
    ``[B, KV, G, S, hd]`` (query head ``h`` reads KV head ``h // G``) the
    G heads of a group sum into their KV head's ``dk``/``dv``.  The
    reference's backward is jnp that XLA runs, not a Pallas kernel; this is
    its plain-torch port, which the card runs as PyTorch ops (a
    hand-written flash backward is later work).  The last chunk is the
    keys left, where the reference pads with masked keys that add 0.
    Returns ``(dq, dk, dv)`` in the inputs' dtypes."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    dt = q.dtype
    qg = q.reshape(B, KV, G * S, hd)
    dog = dout.reshape(B, KV, G * S, hd)
    lse_g = lse.reshape(B, KV, G, S, 1)
    D = (dout.float() * out.float()).sum(-1).reshape(B, KV, G, S, 1)
    dq = torch.zeros((B, KV, G * S, hd), dtype=torch.float32,
                     device=q.device)
    dks, dvs = [], []
    for k0 in range(0, S, KV_CHUNK):
        k1 = min(S, k0 + KV_CHUNK)
        kb, vb = k[:, :, k0:k1], v[:, :, k0:k1]
        s = (qg @ kb.transpose(-1, -2)).float().reshape(
            B, KV, G, S, k1 - k0) * scale
        valid = _chunk_valid(k0, k1, S, causal, window, q.device)
        if valid is not None:
            s = torch.where(valid, s, NEG_INF)
        p = torch.exp(s - lse_g)                       # [B,KV,G,S,C]
        pq = p.to(dt).reshape(B, KV, G * S, k1 - k0)
        dvs.append(pq.transpose(-1, -2) @ dog)
        dp = (dog @ vb.transpose(-1, -2)).float().reshape(p.shape)
        ds = (p * (dp - D) * scale).to(dt).reshape(pq.shape)
        dq = dq + (ds @ kb).float()
        dks.append(ds.transpose(-1, -2) @ qg)
    dq = dq.reshape(B, H, S, hd)
    return (dq.to(dt), torch.cat(dks, dim=2).to(k.dtype),
            torch.cat(dvs, dim=2).to(v.dtype))


class FlashSDPA(torch.autograd.Function):
    """Self-attention with the reference's flash ``custom_vjp``
    (``_chunked_sdpa``): the forward is the flash kernel
    (``kernels.flash_attention.attention``; its plain version on CPU
    tensors), which also writes its log-sum-exp when a gradient is wanted;
    the backward is :func:`flash_backward` on the saved q, k, v, out and
    lse.  ``q`` [B, H, S, hd], ``k``/``v`` [B, KV, S, hd], contiguous;
    ``grad`` is ``torch.is_grad_enabled()`` at the call (inside ``forward``
    grad mode is off, and ``needs_input_grad`` follows ``requires_grad``
    alone), so a call under ``no_grad`` writes no lse and saves nothing.
    The kernel itself has no autograd: called bare on the card, its output
    would carry no gradient to q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int],
                scale: float, grad: bool):
        if not (grad and any(ctx.needs_input_grad[:3])):
            return flash_attention_kernel(q, k, v, causal=causal,
                                          window=window, scale=scale)
        out, lse = flash_attention_kernel(q, k, v, causal=causal,
                                          window=window, scale=scale,
                                          return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attn_args = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.attn_args
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout, causal=causal,
                                    window=window, scale=scale)
        return dq, dk, dv, None, None, None, None


# ---------------------------------------------------------------------------
# GQA full forward (train / prefill / encoder / cross)
# ---------------------------------------------------------------------------

def _project(cfg, p, x, src):
    q, k, v = x @ p.wq, src @ p.wk, src @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return q, k, v


def _heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """[B, S, n * hd] -> [B, n, S, hd]."""
    B, S, _ = t.shape
    return t.reshape(B, S, n, hd).transpose(1, 2)


def gqa_full(cfg, p: Attention, x: torch.Tensor, *, causal: bool = True,
             pos: Optional[torch.Tensor] = None,
             pos3: Optional[torch.Tensor] = None,
             kv_x: Optional[torch.Tensor] = None,
             window: Optional[int] = None) -> torch.Tensor:
    """x [B,S,d].  ``kv_x`` switches to cross-attention (no mask; rope only
    when ``pos`` is given)."""
    B, S, _ = x.shape
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv
    src = kv_x if kv_x is not None else x
    q, k, v = _project(cfg, p, x, src)
    q, k, v = _heads(q, H, hd), _heads(k, KV, hd), _heads(v, KV, hd)

    if pos is not None and cfg.rope_kind == "rope":
        q = apply_rope(q, pos[:, None, :], cfg.rope_theta)
        k = apply_rope(k, pos[:, None, :], cfg.rope_theta)
    elif pos3 is not None and cfg.rope_kind == "mrope":
        q = apply_mrope(q, pos3, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, pos3, cfg.rope_theta, cfg.mrope_sections)

    scale = 1.0 / math.sqrt(hd)
    if kv_x is None:
        # self-attention: the flash kernel at every length (the reference's
        # _sdpa below CHUNKED_SEQ_THRESHOLD and _chunked_sdpa from it on),
        # with _chunked_sdpa's flash backward; masks by index, which is the
        # reference's by pos (0 .. S-1)
        out = FlashSDPA.apply(q.contiguous(), k.contiguous(),
                              v.contiguous(), causal, window, scale,
                              torch.is_grad_enabled())
    else:
        out = _sdpa(q.reshape(B, KV, H // KV, S, hd), k, v, None,
                    scale).reshape(B, H, S, hd)
    return out.transpose(1, 2).reshape(B, S, H * hd) @ p.wo


# ---------------------------------------------------------------------------
# GQA decode with KV cache (ring buffer when cfg.attn_window is set)
# ---------------------------------------------------------------------------

def page_size(capacity: int) -> int:
    """The page size of the decode kernel's view of a cache of
    ``capacity`` keys: the largest divisor of the capacity that is at most
    :data:`PAGE_SIZE`, so the cache is whole pages with no copy (a
    capacity of 10 gives pages of 10 keys, a prime one of 1)."""
    return max(d for d in range(1, min(PAGE_SIZE, capacity) + 1)
               if capacity % d == 0)


def page_table(capacity: int, device) -> torch.Tensor:
    """The identity page table of a contiguous cache of ``capacity`` keys
    (int32, on the cache's device): logical page ``j`` is physical ``j``."""
    return torch.arange(capacity // page_size(capacity), dtype=torch.int32,
                        device=device)


def gqa_cache_init(cfg, batch: int, capacity: int, dtype: torch.dtype,
                   device, table: Optional[torch.Tensor] = None) -> dict:
    """``k``/``v`` ``[B, KV, cap, hd]`` and the page ``table`` the decode
    kernel reads them through (one table can serve every layer)."""
    shape = (batch, cfg.n_kv, capacity, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "table": page_table(capacity, device) if table is None
            else table}


def gqa_decode(cfg, p: Attention, x: torch.Tensor, cache: dict, t: int,
               rope_pos: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """One-token step.  x [B,1,d]; ``t`` the cache position; ``rope_pos``
    overrides the rotary coordinate (VLM text streams are offset from cache
    slots by the vision prefix).  Keys are rope'd before caching, so the
    ring buffer (sliding window) needs only the valid prefix: softmax is
    permutation-invariant over slots.  The cache is updated in place (the
    reference returns a new one) and returned."""
    B = x.shape[0]
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv
    cap = cache["k"].shape[2]
    q, k, v = _project(cfg, p, x, x)
    q, k, v = _heads(q, H, hd), _heads(k, KV, hd), _heads(v, KV, hd)
    if cfg.rope_kind in ("rope", "mrope"):
        # decode treats all streams as text -> plain rope is exact for mrope
        rp = t if rope_pos is None else rope_pos
        posb = torch.full((B, 1, 1), rp, dtype=torch.int32, device=x.device)
        q = apply_rope(q, posb, cfg.rope_theta)
        k = apply_rope(k, posb, cfg.rope_theta)

    slot = t % cap if cfg.attn_window is not None else t
    if not 0 <= slot < cap:
        raise ValueError(f"decode position {t} outside a cache of {cap} "
                         f"keys with no window")
    cache["k"][:, :, slot] = k[:, :, 0]
    cache["v"][:, :, slot] = v[:, :, 0]

    table = cache["table"]
    ps = cap // table.numel()
    pools = [cache[n].view(B * KV, cap // ps, ps, hd) for n in ("k", "v")]
    out = flash_decode_paged(q.reshape(B * H, hd).contiguous(), *pools,
                             table, min(t + 1, cap), groups=H // KV,
                             scale=1.0 / math.sqrt(hd))
    return out.reshape(B, 1, H * hd) @ p.wo, cache


def cross_kv(cfg, p: Attention, enc: torch.Tensor) -> Tuple[torch.Tensor,
                                                           torch.Tensor]:
    """Precompute cross-attention K/V from encoder output (the serve-time
    cache)."""
    k, v = enc @ p.wk, enc @ p.wv
    if cfg.qkv_bias:
        k, v = k + p.bk, v + p.bv
    return _heads(k, cfg.n_kv, cfg.hd), _heads(v, cfg.n_kv, cfg.hd)


def gqa_cross_cached(cfg, p: Attention, x: torch.Tensor, xk: torch.Tensor,
                     xv: torch.Tensor) -> torch.Tensor:
    """Cross-attention against precomputed K/V.  x [B,Q,d]."""
    B, Q, _ = x.shape
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv
    q = x @ p.wq
    if cfg.qkv_bias:
        q = q + p.bq
    q = _heads(q, H, hd).reshape(B, KV, H // KV, Q, hd)
    out = _sdpa(q, xk, xv, None, 1.0 / math.sqrt(hd))
    return out.reshape(B, H, Q, hd).transpose(1, 2).reshape(B, Q, H * hd) \
        @ p.wo


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): latent KV cache; expanded prefill, absorbed decode
# ---------------------------------------------------------------------------

def mla_full(cfg, p: MLA, x: torch.Tensor, *,
             pos: Optional[torch.Tensor] = None,
             window: Optional[int] = None) -> torch.Tensor:
    """Plain torch at every length (the reference's ``_sdpa`` and its
    chunked twin compute the same function)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    qk_head = m.qk_nope + m.qk_rope

    q = ((x @ p.w_dq) @ p.w_uq).reshape(B, S, H, qk_head).transpose(1, 2)
    q_nope, q_rope = q[..., :m.qk_nope], q[..., m.qk_nope:]
    c_kv = x @ p.w_dkv                                     # [B,S,kvl]
    k_rope = x @ p.w_kr                                    # [B,S,rope]
    if pos is None:
        pos = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    q_rope = apply_rope(q_rope, pos[:, None, :], cfg.rope_theta)
    k_rope = apply_rope(k_rope[:, None], pos[:, None, :],
                        cfg.rope_theta)[:, 0]

    # expanded prefill: materialize per-head k/v
    k_nope = torch.einsum("bsl,hdl->bhsd", c_kv, p.w_uk)
    v = torch.einsum("bsl,hlv->bhsv", c_kv, p.w_uv)
    q_eff = torch.cat([q_nope, q_rope], dim=-1)             # [B,H,S,qk]
    k_eff = torch.cat([k_nope, k_rope[:, None].expand(
        *k_nope.shape[:-1], m.qk_rope)], dim=-1)
    mask = _causal_window_mask(pos, pos, window)[:, None, None]
    out = _sdpa(q_eff[:, :, None], k_eff, v, mask,
                1.0 / math.sqrt(qk_head))
    return out[:, :, 0].transpose(1, 2).reshape(B, S, H * m.v_head) @ p.wo


def mla_cache_init(cfg, batch: int, capacity: int, dtype: torch.dtype,
                   device) -> dict:
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, capacity, m.kv_lora), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, capacity, m.qk_rope), dtype=dtype,
                                  device=device)}


def mla_decode(cfg, p: MLA, x: torch.Tensor, cache: dict, t: int,
               rope_pos: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """Absorbed decode: scores and values computed in the latent space —
    the cache stays [B,S,kv_lora+rope], the MLA memory win.  The cache is
    updated in place and returned."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    qk_head = m.qk_nope + m.qk_rope
    cap = cache["c_kv"].shape[1]

    q = ((x @ p.w_dq) @ p.w_uq).reshape(B, 1, H, qk_head).transpose(1, 2)
    q_nope, q_rope = q[..., :m.qk_nope], q[..., m.qk_nope:]
    posb = torch.full((B, 1, 1), t if rope_pos is None else rope_pos,
                      dtype=torch.int32, device=x.device)
    q_rope = apply_rope(q_rope, posb, cfg.rope_theta)
    c_new = x @ p.w_dkv                                    # [B,1,kvl]
    kr_new = apply_rope((x @ p.w_kr)[:, None], posb,
                        cfg.rope_theta)[:, 0]              # [B,1,rope]
    slot = t % cap if cfg.attn_window is not None else t
    if not 0 <= slot < cap:
        raise ValueError(f"decode position {t} outside a cache of {cap} "
                         f"keys with no window")
    cache["c_kv"][:, slot] = c_new[:, 0]
    cache["k_rope"][:, slot] = kr_new[:, 0]
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]

    q_lat = torch.einsum("bhqd,hdl->bhql", q_nope, p.w_uk)
    # f32 products of the operands (the reference's preferred f32 type)
    scores = (torch.einsum("bhql,bsl->bhqs", q_lat.float(), c_kv.float())
              + torch.einsum("bhqd,bsd->bhqs", q_rope.float(),
                             k_rope.float()))
    scores = scores / math.sqrt(qk_head)
    valid = torch.arange(cap, device=x.device) < min(t + 1, cap)
    scores = torch.where(valid, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    out_lat = torch.einsum("bhqs,bsl->bhql", w, c_kv)
    out = torch.einsum("bhql,hlv->bhqv", out_lat, p.w_uv)
    return out.transpose(1, 2).reshape(B, 1, H * m.v_head) @ p.wo, cache
