"""Feed-forward blocks: dense MLP (SwiGLU / GELU) and capacity-based MoE,
the port of the JAX package's ``models/ffn.py``.

The MoE dispatch is gather/scatter with a fixed per-expert capacity, per
group (a batch row): token->slot positions come from an exclusive
cumulative count per expert; overflow tokens drop into a spare row past
the buffer, as the reference's out-of-range slot drops them (standard
capacity-factor semantics).  Expert compute is three batched
products over an ``[E, G*C, d]`` buffer.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .common import _param, act_fn


class MLP(torch.nn.Module):
    """SwiGLU (``w_gate``, ``w_up``, ``w_down``) or GELU (``w_up``,
    ``b_up``, ``w_down``, ``b_down``)."""

    def __init__(self, cfg, device, dtype: torch.dtype,
                 d_ff: Optional[int] = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        if cfg.act == "swiglu":
            self.w_gate = _param((d, f), device, dtype)
            self.w_up = _param((d, f), device, dtype)
            self.w_down = _param((f, d), device, dtype)
        else:
            self.w_up = _param((d, f), device, dtype)
            self.b_up = _param((f,), device, dtype)
            self.w_down = _param((f, d), device, dtype)
            self.b_down = _param((d,), device, dtype)


def mlp(cfg, p: MLP, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "swiglu":
        return (F.silu(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down
    return act_fn(cfg.act)(x @ p.w_up + p.b_up) @ p.w_down + p.b_down


class MoE(torch.nn.Module):
    """Router ``[d, E]`` (f32), experts ``[E, d, f]`` / ``[E, f, d]`` and
    the always-on shared experts (DeepSeek) as one MLP."""

    def __init__(self, cfg, device, dtype: torch.dtype):
        super().__init__()
        m = cfg.moe
        E, d, f = m.n_experts, cfg.d_model, m.d_ff_expert
        self.router = _param((d, E), device, torch.float32)
        self.w_gate = _param((E, d, f), device, dtype)
        self.w_up = _param((E, d, f), device, dtype)
        self.w_down = _param((E, f, d), device, dtype)
        if m.n_shared:
            self.shared = MLP(cfg, device, dtype, d_ff=f * m.n_shared)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest along the last axis, ties to the lower index
    (``jax.lax.top_k``'s order, which ``torch.topk`` does not promise): a
    stable sort of the negated values."""
    idx = torch.sort(-probs, dim=-1, stable=True).indices[..., :k]
    return probs.gather(-1, idx), idx


def moe(cfg, p: MoE, x: torch.Tensor,
        capacity: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,d] -> (out, aux_loss).  Top-k routing with a fixed per-expert
    capacity, computed per group (group = batch row): slot positions come
    from a cumulative count over each group's own tokens only."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, K = m.n_experts, m.top_k
    G = B
    xt = x.reshape(G, S, d)

    probs = torch.softmax(xt.float() @ p.router, dim=-1)       # [G,S,E]
    gate, idx = top_k(probs, K)                                # [G,S,K]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # load-balance auxiliary loss (Switch style, global)
    me = probs.reshape(T, E).mean(0)
    ce = torch.zeros(E, device=x.device).index_add_(
        0, idx.reshape(-1), torch.ones(T * K, device=x.device)) / (T * K)
    aux = E * torch.sum(me * ce) * m.router_aux_weight

    C = capacity or max(1, int(S * K * m.capacity_factor / E))
    flat_e = idx.reshape(G, S * K)                             # [G,S*K]
    # one-hot by comparison (F.one_hot checks its range on the host)
    onehot = (flat_e[..., None]
              == torch.arange(E, device=x.device)).long()      # [G,S*K,E]
    pos_in_e = torch.cumsum(onehot, dim=1) - onehot            # exclusive
    pos = pos_in_e.gather(2, flat_e[..., None])[..., 0]        # [G,S*K]
    keep = (pos < C).reshape(-1)
    # buffer layout [E, G*C, d]: slot = e*(G*C) + g*C + pos
    gidx = torch.arange(G, device=x.device)[:, None]
    slot = (flat_e * (G * C) + gidx * C
            + torch.clamp(pos, max=C - 1)).reshape(-1)

    src = xt.repeat_interleave(K, dim=1).reshape(-1, d)        # [G*S*K,d]
    # kept slots are distinct; a dropped entry goes to the spare row past
    # E*G*C (the reference's out-of-range index under mode="drop"), so the
    # scatter has no mask and reads nothing to the host
    n = E * G * C
    buf = torch.zeros((n + 1, d), dtype=x.dtype, device=x.device)
    buf.index_put_((torch.where(keep, slot, n),), src)
    ebuf = buf[:n].reshape(E, G * C, d)

    h = F.silu(torch.einsum("ecd,edf->ecf", ebuf, p.w_gate)) \
        * torch.einsum("ecd,edf->ecf", ebuf, p.w_up)
    y = torch.einsum("ecf,efd->ecd", h, p.w_down).reshape(E * G * C, d)

    gathered = torch.where(keep[:, None], y[slot], 0.0)        # [G*S*K,d]
    w = gate.reshape(-1)[:, None].to(x.dtype)
    out = (gathered * w).reshape(T, K, d).sum(dim=1).reshape(B, S, d)
    if m.n_shared:
        out = out + mlp(cfg, p.shared, x)
    return out, aux
