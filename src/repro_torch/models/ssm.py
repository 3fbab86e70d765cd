"""State-space blocks: Mamba2 (SSD, Zamba2's workhorse) and RWKV-6 (Finch),
the port of the JAX package's ``models/ssm.py``.

Each has its exact per-token recurrence, its chunk-parallel form (one state
read and write per chunk; exact up to float rounding) and an O(1)-state
single-token decode step.  No Pallas kernel exists for them: they are plain
torch, and the reference's ``lax.scan`` over time (or over chunks) is a
Python loop here, one step a token on the host.  Under the dry run's op
counter each loop runs one step, counted its trip count of times
(:func:`repro_torch.launch.op_cost.time_loop`): every step has the same
shapes.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..launch.op_cost import time_loop, unfold
from .common import _param


# ---------------------------------------------------------------------------
# Mamba2 (simplified SSD: per-head scalar decay, diagonal A)
# ---------------------------------------------------------------------------

def mamba2_dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim


class Mamba2(torch.nn.Module):
    """Separate projections (no packed in_proj), the causal depthwise conv
    over time, and the per-head decay, skip and step-size parameters (f32)."""

    def __init__(self, cfg, device, dtype: torch.dtype):
        super().__init__()
        s, d = cfg.ssm, cfg.d_model
        d_inner, H = mamba2_dims(cfg)
        f32 = torch.float32
        self.w_z = _param((d, d_inner), device, dtype)
        self.w_x = _param((d, d_inner), device, dtype)
        self.w_b = _param((d, s.d_state), device, dtype)
        self.w_c = _param((d, s.d_state), device, dtype)
        self.w_dt = _param((d, H), device, dtype)
        self.conv_w = _param((s.d_conv, d_inner), device, dtype)
        self.conv_b = _param((d_inner,), device, dtype)
        self.a_log = _param((H,), device, f32)          # A = -exp(a_log)
        self.dt_bias = _param((H,), device, f32)
        self.d_skip = _param((H,), device, f32)
        self.w_out = _param((d_inner, d), device, dtype)


def _mamba2_core(cfg, p: Mamba2, xbc, b, c, dtv,
                 h0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recurrent SSD over time.  xbc [B,S,d_inner] (post-conv), b/c
    [B,S,N], dtv [B,S,H]; h0 [B,H,hd,N] -> (y [B,S,d_inner], hT)."""
    d_inner, H = mamba2_dims(cfg)
    hd = cfg.ssm.head_dim
    B_, S, _ = xbc.shape
    a = -torch.exp(p.a_log)                               # [H]
    dt_act = F.softplus(dtv + p.dt_bias)                  # [B,S,H]
    xh = xbc.reshape(B_, S, H, hd)
    h, ys = h0, []
    with time_loop(S) as steps:
        for t in steps:
            xt, bt, ct, dtt = xh[:, t], b[:, t], c[:, t], dt_act[:, t]
            decay = torch.exp(dtt * a)                    # [B,H]
            dx = dtt[..., None] * xt                      # [B,H,hd]
            h = h * decay[..., None, None] \
                + dx[..., None] * bt[:, None, None, :]
            ys.append(torch.einsum("bhdn,bn->bhd", h, ct))
    y = torch.stack(unfold(ys, S), dim=1)                 # [B,S,H,hd]
    y = y + p.d_skip[None, None, :, None] * xh
    return y.reshape(B_, S, d_inner).to(xbc.dtype), h


def _mamba2_split(cfg, p: Mamba2, x):
    return (x @ p.w_z, x @ p.w_x, (x @ p.w_b).float(), (x @ p.w_c).float(),
            (x @ p.w_dt).float())


def _mamba2_chunked(cfg, p: Mamba2, xbc, b, c, dtv, h0, chunk: int):
    """Chunk-parallel SSD: per-head scalar decays make the pairwise ratio
    matrix [C, C] per head — one state IO per chunk instead of per token."""
    d_inner, H = mamba2_dims(cfg)
    hd = cfg.ssm.head_dim
    B_, S, _ = xbc.shape
    a = -torch.exp(p.a_log)
    dt_act = F.softplus(dtv + p.dt_bias)
    xh = xbc.reshape(B_, S, H, hd).float()
    C = chunk
    pad = (-S) % C
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
        dt_act = F.pad(dt_act, (0, 0, 0, pad))
    nc = (S + pad) // C
    tri = torch.tril(torch.ones((C, C), device=xbc.device))   # inclusive
    h, ys = h0, []
    with time_loop(nc) as steps:
        for i in steps:
            sl = slice(i * C, (i + 1) * C)
            xb, bb, cb, dtb = xh[:, sl], b[:, sl], c[:, sl], dt_act[:, sl]
            lam = dtb * a                                   # [B,C,H] (<=0)
            A = torch.cumsum(lam, dim=1)                    # inclusive
            # scores[t,u] = (C_t . B_u) e^{A_t - A_u} dt_u  (u <= t)
            ratio = torch.exp(torch.clamp(A[:, :, None] - A[:, None], -60.0,
                                          0.0))
            cb_dot_bu = torch.einsum("btn,bun->btu", cb, bb)    # [B,C,C]
            scores = cb_dot_bu[:, None] * ratio.permute(0, 3, 1, 2) \
                * dtb.transpose(1, 2)[:, :, None, :]        # [B,H,C,C]
            scores = scores * tri[None, None]
            intra = torch.einsum("bhtu,buhd->bthd", scores, xb)
            inter = torch.exp(A)[..., None] * torch.einsum(
                "btn,bhdn->bthd", cb, h)
            # state: h_C = e^{A_C} h0 + sum_u e^{A_C - A_u} dt_u x_u (x) B_u
            Ac = A[:, -1]                                   # [B,H]
            wgt = torch.exp(torch.clamp(Ac[:, None] - A, -60.0, 0.0)) * dtb
            h = torch.exp(Ac)[..., None, None] * h + torch.einsum(
                "buh,buhd,bun->bhdn", wgt, xb, bb)
            ys.append(intra + inter)
    y = torch.cat(unfold(ys, nc), dim=1)[:, :S]
    y = y + p.d_skip[None, None, :, None] * xh[:, :S]
    return y.reshape(B_, S, d_inner).to(xbc.dtype), h


def mamba2_full(cfg, p: Mamba2, x: torch.Tensor) -> torch.Tensor:
    """Prefill path.  x [B,S,d] -> [B,S,d]."""
    s = cfg.ssm
    d_inner, H = mamba2_dims(cfg)
    B_, S, _ = x.shape
    z, xi, b, c, dtv = _mamba2_split(cfg, p, x)
    # causal depthwise conv over time
    pad = F.pad(xi, (0, 0, s.d_conv - 1, 0))
    xconv = sum(pad[:, i:i + S, :] * p.conv_w[i][None, None, :]
                for i in range(s.d_conv))
    xbc = F.silu(xconv + p.conv_b)
    h0 = torch.zeros((B_, H, s.head_dim, s.d_state), device=x.device)
    if s.chunk:
        y, _ = _mamba2_chunked(cfg, p, xbc, b, c, dtv, h0, s.chunk)
    else:
        y, _ = _mamba2_core(cfg, p, xbc, b, c, dtv, h0)
    return (y * F.silu(z)) @ p.w_out


def mamba2_state_init(cfg, batch: int, dtype: torch.dtype, device) -> dict:
    s = cfg.ssm
    d_inner, H = mamba2_dims(cfg)
    return {"h": torch.zeros((batch, H, s.head_dim, s.d_state),
                             device=device),
            "conv": torch.zeros((batch, s.d_conv - 1, d_inner), dtype=dtype,
                                device=device)}


def mamba2_decode(cfg, p: Mamba2, x: torch.Tensor,
                  state: dict) -> Tuple[torch.Tensor, dict]:
    """One token.  x [B,1,d]; returns a new state."""
    z, xi, b, c, dtv = _mamba2_split(cfg, p, x)
    hist = torch.cat([state["conv"], xi], dim=1)          # [B,d_conv,din]
    xconv = torch.einsum("bkd,kd->bd", hist, p.conv_w)[:, None, :]
    xbc = F.silu(xconv + p.conv_b)
    y, hT = _mamba2_core(cfg, p, xbc, b, c, dtv, state["h"])
    return (y * F.silu(z)) @ p.w_out, {"h": hT, "conv": hist[:, 1:, :]}


# ---------------------------------------------------------------------------
# RWKV-6 (Finch): data-dependent decay linear attention
# ---------------------------------------------------------------------------

def rwkv6_dims(cfg):
    hd = cfg.ssm.head_dim
    return cfg.d_model // hd, hd          # (n_heads, head_dim)


class RWKV6(torch.nn.Module):
    """Time mix (receptance, key, value, gate, data-dependent decay, bonus,
    per-head norm scale) and channel mix (``cm_k``, ``cm_v``)."""

    def __init__(self, cfg, device, dtype: torch.dtype):
        super().__init__()
        d = cfg.d_model
        H, hd = rwkv6_dims(cfg)
        f32 = torch.float32
        for name in ("w_r", "w_k", "w_v", "w_g", "w_decay"):
            setattr(self, name, _param((d, d), device, dtype))
        self.decay_bias = _param((d,), device, f32)
        self.u_bonus = _param((H, hd), device, f32)
        self.w_out = _param((d, d), device, dtype)
        self.ln_w = _param((d,), device, dtype)
        self.cm_k = _param((d, cfg.d_ff), device, dtype)
        self.cm_v = _param((cfg.d_ff, d), device, dtype)


def _rwkv6_core(cfg, p: RWKV6, r, k, v, w, s0):
    """Linear-attention recurrence.  r,k,v [B,S,H,hd]; w (decay in (0,1))
    [B,S,H,hd]; s0 [B,H,hd,hd]."""
    u = p.u_bonus                                          # [H,hd]
    S = r.shape[1]
    s, ys = s0, []
    with time_loop(S) as steps:
        for t in steps:
            rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
            kv = kt[..., :, None] * vt[..., None, :]       # [B,H,hd,hd]
            ys.append(torch.einsum("bhk,bhkv->bhv", rt,
                                   s + u[None, :, :, None] * kv))
            s = wt[..., :, None] * s + kv
    return torch.stack(unfold(ys, S), dim=1), s            # [B,S,H,hd]


def _rwkv6_proj(cfg, p: RWKV6, x):
    H, hd = rwkv6_dims(cfg)
    B_, S, _ = x.shape
    r = (x @ p.w_r).reshape(B_, S, H, hd).float()
    k = (x @ p.w_k).reshape(B_, S, H, hd).float()
    v = (x @ p.w_v).reshape(B_, S, H, hd).float()
    g = F.silu(x @ p.w_g)
    decay = torch.exp(-torch.exp((x @ p.w_decay).float() + p.decay_bias))
    return r, k, v, g, decay.reshape(B_, S, H, hd)


def _rwkv6_out(cfg, p: RWKV6, ys, g):
    B_, S = ys.shape[:2]
    y = ys.reshape(B_, S, -1)
    # group-norm per head approximated by rmsnorm over the full dim
    y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + 1e-6)
    y = (y * p.ln_w.float()).to(g.dtype)
    return (y * g) @ p.w_out


def _rwkv6_chunked(cfg, p: RWKV6, r, k, v, w, s0, chunk: int):
    """Chunk-parallel RWKV-6 (GLA-style): per-token state IO becomes one
    state read/write per chunk; intra-chunk interactions are masked
    products with pairwise decay ratios exp(L_{t-1} - L_u) <= 1.  Exact (up
    to fp) against the per-token recurrence."""
    B_, S, H, hd = r.shape
    C = chunk
    pad = (-S) % C
    if pad:
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    nc = (S + pad) // C
    u = p.u_bonus
    tri = torch.tril(torch.ones((C, C), device=r.device), diagonal=-1)
    s, ys = s0, []
    with time_loop(nc) as steps:
        for i in steps:
            sl = slice(i * C, (i + 1) * C)
            rb, kb, vb, wb = r[:, sl], k[:, sl], v[:, sl], w[:, sl]
            logw = torch.log(torch.clamp(wb, min=1e-30))
            L = torch.cumsum(logw, dim=1)                  # L_t (inclusive)
            Lm1 = L - logw                                 # L_{t-1}
            # intra-chunk: A[t,u] = sum_d r_t k_u exp(L_{t-1}-L_u), u < t
            ex = torch.exp(torch.clamp(Lm1[:, :, None] - L[:, None], -60.0,
                                       0.0))
            scores = torch.einsum("bthd,buhd,btuhd->bhtu", rb, kb, ex)
            scores = scores * tri[None, None]
            intra = torch.einsum("bhtu,buhd->bthd", scores, vb)
            diag = torch.einsum("bthd,bthd->bth", rb * u[None, None], kb)
            intra = intra + diag[..., None] * vb
            inter = torch.einsum("bthk,bhkv->bthv", rb * torch.exp(Lm1), s)
            # state: S1 = diag(exp(L_C)) S0 + sum_u (k_u exp(L_C-L_u)) v_u
            Lc = L[:, -1]                                      # [B,H,hd]
            kk = kb * torch.exp(torch.clamp(Lc[:, None] - L, -60.0, 0.0))
            s = torch.exp(Lc)[..., None] * s + torch.einsum("buhk,buhv->bhkv",
                                                            kk, vb)
            ys.append(intra + inter)
    return torch.cat(unfold(ys, nc), dim=1)[:, :S], s


def rwkv6_time_mix(cfg, p: RWKV6, x: torch.Tensor) -> torch.Tensor:
    H, hd = rwkv6_dims(cfg)
    r, k, v, g, w = _rwkv6_proj(cfg, p, x)
    s0 = torch.zeros((x.shape[0], H, hd, hd), device=x.device)
    if cfg.ssm.chunk:
        ys, _ = _rwkv6_chunked(cfg, p, r, k, v, w, s0, cfg.ssm.chunk)
    else:
        ys, _ = _rwkv6_core(cfg, p, r, k, v, w, s0)
    return _rwkv6_out(cfg, p, ys, g)


def rwkv6_state_init(cfg, batch: int, device) -> dict:
    H, hd = rwkv6_dims(cfg)
    return {"s": torch.zeros((batch, H, hd, hd), device=device)}


def rwkv6_decode(cfg, p: RWKV6, x: torch.Tensor,
                 state: dict) -> Tuple[torch.Tensor, dict]:
    r, k, v, g, w = _rwkv6_proj(cfg, p, x)
    ys, sT = _rwkv6_core(cfg, p, r, k, v, w, state["s"])
    return _rwkv6_out(cfg, p, ys, g), {"s": sT}


def rwkv6_channel_mix(cfg, p: RWKV6, x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x @ p.cm_k)) @ p.cm_v
