"""OLMo-1B's forward pass in plain float32 PyTorch (arXiv:2402.00838; the
widths of allenai/OLMo-1B's config.json).

A decoder of ``n_layers`` pre-norm blocks over token embeddings:

    h = LN(x);  x = x + Attn(h);  x = x + W_down (silu(h2 W_gate) * h2 W_up)
    with h2 = LN(x);  logits = LN(x) @ E^T (tied embeddings)

LN is the non-parametric layer norm (no scale, no bias, eps 1e-5).
Attention is causal multi-head attention, ``n_kv`` K/V heads shared by
``n_heads / n_kv`` query heads each, with rotary embeddings on q and k
(the rotate-half form: the first and second halves of a head are the
pair, frequencies ``theta ** (-2 i / hd)``), scale ``1 / sqrt(hd)``.
Projections are ``x @ W`` with ``W`` stored ``[d_in, d_out]``.

It reads the weights by the parameter names of the benchmark's set
(``tok_emb``, ``blocks.<i>.attn.{wq,wk,wv,wo}``, ``blocks.<i>.mlp.{w_gate,
w_up,w_down}``), in whatever dtype they were made, and computes in f32.
``rounding`` puts every product's operands through a lower precision
first (:mod:`bench.reference.precision`): the control.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch


def layout(model: Mapping) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """The weights' names, shapes and deviations: embeddings N(0, 0.02^2),
    every projection N(0, 1 / fan_in)."""
    d, H, KV, f = (model["d_model"], model["n_heads"], model["n_kv"],
                   model["d_ff"])
    hd = model.get("head_dim") or d // H
    out = {"tok_emb": ((model["vocab"], d), 0.02)}
    for i in range(model["n_layers"]):
        p = f"blocks.{i}."
        for name, shape in (("attn.wq", (d, H * hd)),
                            ("attn.wk", (d, KV * hd)),
                            ("attn.wv", (d, KV * hd)),
                            ("attn.wo", (H * hd, d)),
                            ("mlp.w_gate", (d, f)), ("mlp.w_up", (d, f)),
                            ("mlp.w_down", (f, d))):
            out[p + name] = (shape, shape[0] ** -0.5)
    return out


#: the settings of the block this module computes, as the port's model
#: configuration names them
BLOCK = {"family": "dense", "norm": "nonparam_ln", "act": "swiglu",
         "rope_kind": "rope", "tie_embeddings": True, "qkv_bias": False,
         "attn_window": None}


def check(config: Mapping) -> None:
    """Raises ``ValueError`` where ``config`` describes another block than
    this module computes."""
    other = {k: config.get(k) for k in BLOCK if config.get(k) != BLOCK[k]}
    if other:
        raise ValueError(f"the OLMo reference computes {BLOCK}, not {other}")


def layernorm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [H, S, hd] at positions 0 .. S-1."""
    S, hd = x.shape[-2], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def logits(weights: Mapping[str, torch.Tensor], model: Mapping,
           tokens: torch.Tensor, positions: torch.Tensor,
           rounding: Optional[Callable] = None) -> torch.Tensor:
    """f32 logits ``[len(positions), vocab]`` of the sequence ``tokens``
    (``[S]`` int) at ``positions``, each the distribution over the token
    after it."""
    r = rounding or (lambda t: t)

    def mm(a, b):
        return r(a) @ r(b)

    def w(name):
        return weights[name].float()

    H, KV = model["n_heads"], model["n_kv"]
    hd = model.get("head_dim") or model["d_model"] // H
    S = tokens.shape[0]
    x = w("tok_emb")[tokens]
    causal = torch.ones((S, S), dtype=torch.bool,
                        device=x.device).tril()
    for i in range(model["n_layers"]):
        p = f"blocks.{i}."
        h = layernorm(x)
        q = mm(h, w(p + "attn.wq")).reshape(S, H, hd).transpose(0, 1)
        k = mm(h, w(p + "attn.wk")).reshape(S, KV, hd).transpose(0, 1)
        v = mm(h, w(p + "attn.wv")).reshape(S, KV, hd).transpose(0, 1)
        q, k = rope(q, model["rope_theta"]), rope(k, model["rope_theta"])
        k = k.repeat_interleave(H // KV, dim=0)
        v = v.repeat_interleave(H // KV, dim=0)
        s = mm(q, k.transpose(1, 2)) / math.sqrt(hd)
        a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        o = mm(a, v).transpose(0, 1).reshape(S, H * hd)
        x = x + mm(o, w(p + "attn.wo"))
        h = layernorm(x)
        g = torch.nn.functional.silu(mm(h, w(p + "mlp.w_gate")))
        x = x + mm(g * mm(h, w(p + "mlp.w_up")), w(p + "mlp.w_down"))
    return mm(layernorm(x[positions]), w("tok_emb").T)
