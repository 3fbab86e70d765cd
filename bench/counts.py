"""The benchmark's own operation and byte counts, from a configuration's
widths, and the H100's published peaks.

These are the yardstick of the roofline and MFU metrics, kept here so that
a change to the program cannot move them.  Counts are those the algorithm
needs: a product of an ``[m, k]`` and a ``[k, n]`` matrix is ``2 m k n``
operations; each input byte is read once and each output byte written
once, whatever a kernel reads again.

Widths are a configuration file's ``model`` object: ``n_layers``,
``d_model``, ``n_heads``, ``n_kv``, ``head_dim`` (0: ``d_model //
n_heads``), ``d_ff``, ``vocab`` and ``mlp`` (``"swiglu"``: three
``d x d_ff`` matrices; ``"relu"``: two).
"""
from __future__ import annotations

from typing import Dict, Mapping

#: NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
PEAK_FLOPS: Dict[str, float] = {
    "bfloat16": 989e12,      # tensor cores
    "float16": 989e12,
    "float32": 67e12,        # CUDA cores, outside the tensor cores
}
HBM_BYTES_PER_S = 3.35e12
#: the paged decode kernel computes in f32 FMAs on the CUDA cores, in
#: either input dtype
DECODE_KERNEL_FLOPS = PEAK_FLOPS["float32"]

ELEMENT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def head_dim(w: Mapping) -> int:
    return int(w.get("head_dim") or w["d_model"] // w["n_heads"])


def mlp_matrices(w: Mapping) -> int:
    """``d x d_ff`` matrices of one block's MLP."""
    kinds = {"swiglu": 3, "relu": 2}
    if w["mlp"] not in kinds:
        raise ValueError(f"no count for the MLP {w['mlp']!r}")
    return kinds[w["mlp"]]


def block_matmul_flops(w: Mapping) -> float:
    """One token through every block's projections and MLP."""
    d, hd = w["d_model"], head_dim(w)
    attn = 2 * d * hd * (2 * w["n_heads"] + 2 * w["n_kv"])   # q, o; k, v
    mlp = 2 * d * w["d_ff"] * mlp_matrices(w)
    return float(w["n_layers"] * (attn + mlp))


def attention_flops(w: Mapping, kv_len: int) -> float:
    """One query token against ``kv_len`` keys in every block: scores and
    the weighted sum of values, ``2 * hd * kv_len`` each a head."""
    return float(w["n_layers"] * w["n_heads"] * 4 * head_dim(w) * kv_len)


def logits_flops(w: Mapping) -> float:
    return float(2 * w["d_model"] * w["vocab"])


def token_flops(w: Mapping, kv_len: int, logits: bool) -> float:
    """One decode step of one sequence at ``kv_len`` live keys."""
    return (block_matmul_flops(w) + attention_flops(w, kv_len)
            + (logits_flops(w) if logits else 0.0))


def steps_flops(w: Mapping, first: int, last: int, logits: bool) -> float:
    """Steps at positions ``first .. last - 1`` (``kv_len = pos + 1``) of
    one sequence, in closed form."""
    n = max(0, last - first)
    keys = n * (first + last + 1) / 2.0          # sum of pos + 1
    per_key = attention_flops(w, 1)
    fixed = block_matmul_flops(w) + (logits_flops(w) if logits else 0.0)
    return n * fixed + keys * per_key


def decode_call_work(rows: int, kv_rows: int, kv_len: int, hd: int,
                     esize: int) -> tuple:
    """(operations, bytes) of one paged decode call: ``rows`` query rows
    over ``kv_rows`` pool rows (``rows / kv_rows`` query heads a KV head)
    at ``kv_len`` live keys.  Bytes: the live K and V once, q read, the
    output written."""
    flops = 4.0 * rows * hd * kv_len
    nbytes = float(esize) * hd * (2 * kv_rows * kv_len + 2 * rows)
    return flops, nbytes


def least_seconds(flops: float, nbytes: float,
                  peak_flops: float = DECODE_KERNEL_FLOPS) -> float:
    """The roofline's least time: the larger of the operations at the
    peak rate and the bytes at the memory bandwidth."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)
