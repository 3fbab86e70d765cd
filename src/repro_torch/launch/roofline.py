"""Roofline terms of a dry-run record (the port of the JAX package's
``launch/roofline.py``).

Three terms per (arch, shape, mesh), each per device:

    compute    = FLOPs / peak_FLOP/s
    memory     = bytes / HBM_bw
    collective = collective_bytes / link_bw

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` and
parses collective bytes from the optimized HLO (``collective_bytes``,
``analyze``).  PyTorch has neither: the port's counts come from its op
counter, :mod:`repro_torch.launch.op_cost`, and its collective bytes from
the sharding specs (:func:`repro_torch.launch.dryrun.collectives`), so
those two functions have no counterpart here.  :class:`Roofline` and
:func:`model_flops_estimate` are the reference's, on the H100's constants.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float                 # per device (the counted step's)
    hlo_bytes: float                 # per device
    coll_bytes: Dict[str, int]       # per device
    model_flops: float = 0.0         # whole model (all chips)
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / self.hbm_bw

    @property
    def t_collective(self) -> float:
        # collective bytes are already per-device; a card drives one NIC
        return sum(self.coll_bytes.values()) / self.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    def row(self) -> Dict[str, object]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes": dict(self.coll_bytes),
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
        }


def model_flops_estimate(cfg, seq: int, batch: int, mode: str) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (inference forward), with
    N = active params (MoE counts routed active + shared)."""
    # active params per token
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    emb = V * d * (1 if cfg.tie_embeddings else 2)
    per_layer = 0.0
    hd = cfg.hd if cfg.n_heads else 0
    if cfg.family in ("dense", "vlm", "moe"):
        if cfg.mla:
            m = cfg.mla
            attn = (d * m.q_lora + m.q_lora * cfg.n_heads * (m.qk_nope
                                                             + m.qk_rope)
                    + d * m.kv_lora + d * m.qk_rope
                    + m.kv_lora * cfg.n_heads * (m.qk_nope + m.v_head)
                    + cfg.n_heads * m.v_head * d)
        else:
            attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv * hd \
                + cfg.n_heads * hd * d
        if cfg.moe:
            mo = cfg.moe
            ffn = 3 * d * mo.d_ff_expert * (mo.top_k + mo.n_shared)
        else:
            ffn = (3 if cfg.act == "swiglu" else 2) * d * cfg.d_ff
        per_layer = attn + ffn
    elif cfg.family == "ssm":
        per_layer = 6 * d * d + 2 * d * cfg.d_ff   # r,k,v,g,decay,out + cm
    elif cfg.family == "hybrid":
        din = cfg.ssm.expand * d
        per_layer = 2 * d * din + din * d          # z,x,out projections
    elif cfg.family == "encdec":
        attn = 4 * d * d
        per_layer = attn * 2 + (2 * d * cfg.d_ff)  # self+cross, gelu mlp
    n_active = emb + L * per_layer
    tokens = batch * (seq if mode in ("train", "prefill") else 1)
    mult = 6.0 if mode == "train" else 2.0
    return mult * n_active * tokens
