"""Shared model building blocks: the port of the JAX package's
``models/common.py`` (norms, RoPE and M-RoPE, sinusoidal positions,
activations, cross-entropy, initializers).

Norms and rotary embeddings upcast to f32 inside and cast back to the
input dtype, as the reference does; in bf16 those upcasts decide the
results.  The initializers draw from an explicit ``torch.Generator``: the
distributions are the reference's, the bits are not (``jax.random`` and
torch's generators differ), so tests carry the reference's weights across
(:func:`repro_torch.models.transformer.params_from_numpy`).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def normal(gen: torch.Generator, shape, std: float,
           dtype: torch.dtype) -> torch.Tensor:
    """``N(0, std^2)`` drawn in f32 on the generator's device, then cast."""
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * std).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype) -> torch.Tensor:
    return normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    return normal(gen, (vocab, d), 0.02, dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, weight: Optional[torch.Tensor],
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    if weight is not None:
        x = x * weight.float()
    return x.to(dt)


def layernorm(x: torch.Tensor, weight: Optional[torch.Tensor],
              bias: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        x = x * weight.float()
    if bias is not None:
        x = x + bias.float()
    return x.to(dt)


def apply_norm(cfg, x: torch.Tensor, p) -> torch.Tensor:
    """Dispatch on ``cfg.norm``; ``p`` is a :class:`Norm` (``nonparam_ln``,
    OLMo's, has no parameters at all)."""
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p.w)
    if cfg.norm == "layernorm":
        return layernorm(x, p.w, p.b)
    if cfg.norm == "nonparam_ln":
        return layernorm(x, None, None)
    raise ValueError(cfg.norm)


class Norm(torch.nn.Module):
    """The parameters of one norm: ``w`` (rmsnorm), ``w`` and ``b``
    (layernorm) or none (``nonparam_ln``)."""

    def __init__(self, cfg, d: int, device, dtype: torch.dtype):
        super().__init__()
        self.w = self.b = None
        if cfg.norm in ("rmsnorm", "layernorm"):
            self.w = _param((d,), device, dtype)
        if cfg.norm == "layernorm":
            self.b = _param((d,), device, dtype)


def _param(shape, device, dtype) -> torch.nn.Parameter:
    """An uninitialised weight, created frozen (``requires_grad=False``):
    serving keeps no gradient state; training turns gradients on with
    ``model.requires_grad_(True)`` (``runtime.steps.make_train_step``)."""
    return torch.nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                              requires_grad=False)


# ---------------------------------------------------------------------------
# RoPE (standard + M-RoPE + sinusoidal abs-pos for whisper)
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, hd]; pos: broadcastable to [..., S]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # [hd/2]
    return _rotate(x, pos[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, pos3: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x: [B, H, S, hd]; ``pos3``: [B, 3, S]
    (temporal, height, width coordinate streams).  ``sections`` partition
    the hd/2 frequency slots among the 3 streams; text tokens carry
    identical coords in all three streams, making this exactly standard
    RoPE for text."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"mrope sections {sections} do not sum to hd/2 "
                         f"for hd {hd}")
    freqs = rope_freqs(hd, theta, x.device)
    # frequency slot j reads the stream whose section holds it: stream i's
    # coordinates repeated over its section (no index tensor from the host)
    B, _, S = pos3.shape
    pos_sel = torch.cat([pos3[:, i, :, None].expand(B, S, s)
                         for i, s in enumerate(sections)], dim=-1)
    return _rotate(x, pos_sel.float()[:, None] * freqs)       # [B, S, hd/2]


def sinusoidal_pos_at(t, d: int, device) -> torch.Tensor:
    """Sinusoidal embedding [d] for one position, in f32 (the reference
    computes this one in f32 and :func:`sinusoidal_pos` in float64).  ``t``
    is an int or a 0-d integer tensor on ``device``, read where it lies (a
    captured decode step reads its position from device memory)."""
    i = torch.arange(d // 2, dtype=torch.float32, device=device)
    pos = t.float() if isinstance(t, torch.Tensor) else \
        torch.tensor(float(t), dtype=torch.float32, device=device)
    ang = pos / (10000 ** (2 * i / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)])


def sinusoidal_pos(seq: int, d: int, device) -> torch.Tensor:
    """Sinusoidal embeddings [seq, d] in f32, computed in float64 as the
    reference computes them in numpy; made on ``device`` (no host data
    inside a step, which a captured train step could not copy)."""
    f64 = torch.float64
    pos = torch.arange(seq, dtype=f64, device=device)[:, None]
    i = torch.arange(d // 2, dtype=f64, device=device)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).float()


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def act_fn(name: str):
    if name == "swiglu":
        raise ValueError("swiglu is handled inside the MLP (two inputs)")
    if name == "gelu":      # jax.nn.gelu's default is the tanh form
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token CE in fp32. logits [..., V], labels [...] int; with
    ``mask`` [...] the mean over the masked-in tokens, ``sum(nll * mask) /
    max(sum(mask), 1)``.  The gold logit is a gather (the reference's
    masked sum over a one-hot adds exact zeros: the same value)."""
    logits = logits.float()
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = torch.logsumexp(logits, dim=-1) - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
