"""The decode slice's transformer in plain float32 PyTorch: the block that
FlexPie's planner shards over edge nodes, at the widths a configuration
gives.

    a = rms(x);  x = x + MHA(a) @ Wo;  f = rms(x);  x = x + relu(f W1) W2
    logits = x @ E^T

``rms(x) = x / sqrt(mean(x^2) + 1e-6)`` over a token's features, with no
scale.  MHA is causal multi-head attention with ``n_heads`` heads of
``d_model / n_heads``, no rotary embedding, scale ``1 / sqrt(hd)``; q, k
and v are ``a @ Wq``, ``a @ Wk``, ``a @ Wv``.  There is no final norm: the
logits read the last block's output.  Weights are ``{"emb": [vocab, d],
"blocks": [{wq, wk, wv, wo, w1, w2}, ...]}``, ``[d_in, d_out]`` each.
``rounding`` puts every product's operands through a lower precision
first (:mod:`bench.reference.precision`): the control.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch


def layout(model: Mapping) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """The weights' names (``emb``, ``blocks.<i>.<w>``), shapes and
    deviations: the decode slice's own, ``d ** -0.5`` for every ``[d, *]``
    matrix, ``d_ff ** -0.5`` for ``w2`` and 1 for the embeddings."""
    d, f = model["d_model"], model["d_ff"]
    out = {"emb": ((model["vocab"], d), 1.0)}
    for i in range(model["n_layers"]):
        for name, shape in (("wq", (d, d)), ("wk", (d, d)), ("wv", (d, d)),
                            ("wo", (d, d)), ("w1", (d, f)), ("w2", (f, d))):
            out[f"blocks.{i}.{name}"] = (shape, shape[0] ** -0.5)
    return out


def nest(flat: Mapping[str, torch.Tensor], n_layers: int) -> Dict:
    """``{"emb", "blocks": [{wq, ...}, ...]}`` from :func:`layout`'s
    names."""
    blocks = [{} for _ in range(n_layers)]
    for name, t in flat.items():
        if name.startswith("blocks."):
            _, i, w = name.split(".")
            blocks[int(i)][w] = t
    return {"emb": flat["emb"], "blocks": blocks}


def rms(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6)


def logits(weights: Mapping, model: Mapping, tokens: torch.Tensor,
           positions: torch.Tensor,
           rounding: Optional[Callable] = None) -> torch.Tensor:
    """f32 logits ``[len(positions), vocab]`` of the sequence ``tokens``
    (``[S]`` int) at ``positions``."""
    r = rounding or (lambda t: t)

    def mm(a, b):
        return r(a) @ r(b)

    H = model["n_heads"]
    hd = model["d_model"] // H
    S = tokens.shape[0]
    x = weights["emb"].float()[tokens]
    causal = torch.ones((S, S), dtype=torch.bool,
                        device=x.device).tril()
    for blk in weights["blocks"]:
        a = rms(x)
        q, k, v = (mm(a, blk[n]).reshape(S, H, hd).transpose(0, 1)
                   for n in ("wq", "wk", "wv"))
        s = mm(q, k.transpose(1, 2)) / math.sqrt(hd)
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        x = x + mm(mm(p, v).transpose(0, 1).reshape(S, H * hd), blk["wo"])
        f = rms(x)
        x = x + mm(torch.relu(mm(f, blk["w1"])), blk["w2"])
    return mm(x[positions], weights["emb"].float().T)
