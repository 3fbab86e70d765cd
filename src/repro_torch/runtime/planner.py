"""FlexPie FCO applied to the production mesh: choose a Strategy per block
class (the port of the JAX package's ``runtime/planner.py``).

The mapping: each block class of the architecture becomes one "layer" of a
proxy :class:`ModelGraph`; the mesh's model axis plays the edge cluster
("nodes" = model-axis size, "bandwidth" = the link, "device_gflops" = one
card's peak).  The scheme alphabet is restricted to

    INH   -> "sp"  (sequence-parallel activations, replicated weights)
    OUTC  -> "tp"  (tensor-parallel weights — heads / FFN / experts)

and the T/NT alternative corresponds to re-gathering activations at the
block boundary vs. leaving them sharded through norm/residual (redundant
small-op compute).  We then run the *same* ``core.plan_search`` DP used on
the edge side, with a roofline estimator implementing the
``CostEstimator`` protocol — the paper's machinery end-to-end, new physics.

The reference prices a TPU v5e mesh; :class:`H100RooflineEstimator` takes
its three constants as arguments (default: the H100 SXM's, from
:mod:`repro_torch.launch.mesh`), so built with v5e's it is the reference's
estimator, term for term.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..core.cost import Testbed
from ..core.dpp import Objective, plan_search
from ..core.graph import ConvT, LayerSpec, ModelGraph
from ..core.partition import Scheme
from ..launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16
from .shard_plan import Strategy

_SCHEMES = (Scheme.INH, Scheme.OUTC)   # sp, tp


class H100RooflineEstimator:
    """i/s-cost oracle for the proxy graph: roofline terms on a mesh of
    cards of ``peak_flops`` (bf16), ``hbm_bw`` and ``link_bw`` (bytes/s a
    card sends).

    ``layer.in_h`` = tokens per data-shard, ``in_c/out_c`` = matmul dims.
    ``extra_flop_factor`` folds attention-score FLOPs.  Infeasible schemes
    (non-divisible TP) return +inf, the divisibility rule of shard_plan.
    """

    def __init__(self, model_axis: int, divisible: dict,
                 kv_dim: Optional[dict] = None, *,
                 peak_flops: float = PEAK_FLOPS_BF16,
                 hbm_bw: float = HBM_BW, link_bw: float = LINK_BW):
        self.m = model_axis
        self.divisible = divisible   # layer name -> TP divisibility ok?
        # attention layers under SP must all-gather K/V over the model axis
        # (this is what makes SP lose for MLA/DeepSeek)
        self.kv_dim = kv_dim or {}
        self.peak_flops = peak_flops
        self.hbm_bw = hbm_bw
        self.link_bw = link_bw

    def i_cost(self, layer, scheme, tb, extra_halo: int = 0) -> float:
        flops = layer.flops()
        t_link = 0.0
        if scheme == Scheme.OUTC:
            if not self.divisible.get(layer.name, True):
                return float("inf")
            shard_flops = flops / self.m
            weight_bytes = layer.weight_elems() * 2 / self.m
        else:  # INH: sequence-parallel — weights replicated on each card
            shard_flops = flops / self.m
            weight_bytes = layer.weight_elems() * 2
            kv = self.kv_dim.get(layer.name, 0)
            if kv:
                # gather K and V (bf16) for the full sequence per card
                t_link = (2.0 * layer.in_h * kv * 2.0
                          * (self.m - 1) / self.m) / self.link_bw
        act_bytes = (layer.in_elems() + layer.out_elems()) * 2 / self.m
        t_compute = shard_flops / (self.peak_flops * 0.5)
        t_memory = (weight_bytes + act_bytes) / self.hbm_bw
        return max(t_compute, t_memory) + t_link

    def s_cost(self, layer, nxt, src, dst, tb) -> float:
        """Boundary re-layout on the model axis (a ring over the links)."""
        out_bytes = layer.out_elems() * 2
        if nxt is None:
            return 0.0
        if src == dst:
            if src == Scheme.OUTC:
                # TP partial sums -> all-reduce 2x(m-1)/m
                return 2 * out_bytes * (self.m - 1) / self.m / self.link_bw
            return 0.0   # SP -> SP: already aligned
        # layout change (all-gather then re-shard)
        return out_bytes * (self.m - 1) / self.m / self.link_bw * 2


def _proxy_graph(cfg, tokens_per_dp: int, model_axis: int):
    """One FC layer per block class + divisibility/kv tables."""
    d = cfg.d_model
    layers = []
    div = {}
    kv_dim = {}
    m = model_axis

    def fc(name, cin, cout, extra=1.0, tp_ok=True, kv=0):
        layers.append(LayerSpec(name, ConvT.FC, tokens_per_dp, 1,
                                cin, cout, extra_flop_factor=extra))
        div[name] = tp_ok
        if kv:
            kv_dim[name] = kv

    if cfg.family in ("dense", "vlm", "moe"):
        hd = cfg.hd
        if cfg.mla:
            qk = cfg.mla.qk_nope + cfg.mla.qk_rope
            fc("attn", d, cfg.n_heads * qk,
               extra=1.0 + cfg.mla.kv_lora / qk,
               tp_ok=(cfg.n_heads * qk) % m == 0,
               # expanded-prefill K/V are per-head: the SP gather is huge
               kv=cfg.n_heads * (qk + cfg.mla.v_head))
        else:
            fc("attn", d, cfg.n_heads * hd,
               extra=2.0,   # k/v/o projections + scores folded
               tp_ok=(cfg.n_heads * hd) % m == 0 and (cfg.n_kv * hd) % m == 0,
               kv=2 * cfg.n_kv * hd)
        if cfg.moe:
            mo = cfg.moe
            active = mo.top_k + mo.n_shared
            fc("ffn", d, mo.d_ff_expert * active, extra=3.0,
               tp_ok=mo.d_ff_expert % m == 0 or mo.n_experts % m == 0)
        else:
            fc("ffn", d, cfg.d_ff, extra=3.0 if cfg.act == "swiglu" else 2.0,
               tp_ok=cfg.d_ff % m == 0)
    elif cfg.family == "hybrid":
        din = cfg.ssm.expand * d
        fc("ssm", d, din, extra=3.0, tp_ok=din % m == 0)
        fc("attn", d, cfg.n_heads * cfg.hd, extra=2.0,
           tp_ok=(cfg.n_heads * cfg.hd) % m == 0, kv=2 * cfg.n_kv * cfg.hd)
        fc("ffn", d, cfg.d_ff, extra=3.0, tp_ok=cfg.d_ff % m == 0)
    elif cfg.family == "ssm":
        fc("ssm", d, 6 * d, extra=1.0, tp_ok=d % m == 0)
        fc("ffn", d, cfg.d_ff, extra=2.0, tp_ok=cfg.d_ff % m == 0)
    elif cfg.family == "encdec":
        fc("attn", d, 4 * d, extra=2.0,
           tp_ok=(cfg.n_heads * cfg.hd) % m == 0, kv=2 * cfg.n_kv * cfg.hd)
        fc("ffn", d, cfg.d_ff, extra=2.0, tp_ok=cfg.d_ff % m == 0)
    return (ModelGraph(name=cfg.name + "-proxy", layers=_chainify(layers)),
            div, kv_dim)


def _chainify(layers):
    """Force chain consistency (proxy layers all share in_h=tokens, w=1)."""
    fixed = []
    for i, l in enumerate(layers):
        if i == 0:
            fixed.append(l)
        else:
            prev = fixed[-1]
            fixed.append(dataclasses.replace(l, in_h=prev.out_h,
                                             in_w=prev.out_w,
                                             in_c=prev.out_c))
    return tuple(fixed)


def choose_strategy(cfg, mesh, mode: str,
                    use_planner: bool = True,
                    objective: Objective = Objective.LATENCY,
                    latency_bound_s: Optional[float] = None, *,
                    peak_flops: float = PEAK_FLOPS_BF16,
                    hbm_bw: float = HBM_BW,
                    link_bw: float = LINK_BW) -> Strategy:
    """Run the FCO planner over the proxy graph and map schemes back.

    ``objective`` threads the serving objective through to the DP:
    ``Objective.THROUGHPUT`` picks the block strategy that maximizes
    steady-state pipelined step rate (decode serving, where batches
    stream through the mesh and link collectives overlap the next batch's
    compute), ``P99_BOUNDED`` constrains it to a per-step latency bound.
    The roofline estimator is scalar-only, so these run the
    scalar-provider frontier path of ``plan_search``.  The three hardware
    constants default to the H100's; the reference's v5e constants give
    the reference's strategy."""
    m = mesh.shape["model"]

    # resident decode weights when the TP-sharded model fits comfortably
    param_bytes = _param_bytes_estimate(cfg)
    resident = mode != "train" and param_bytes / m < 6e9

    if not use_planner:
        return Strategy(decode_resident=resident)

    tokens = 4096 if mode == "train" else (32768 if mode == "prefill" else 1)
    graph, div, kv_dim = _proxy_graph(cfg, max(1, tokens), m)
    est = H100RooflineEstimator(m, div, kv_dim, peak_flops=peak_flops,
                                hbm_bw=hbm_bw, link_bw=link_bw)
    tb = Testbed(nodes=m, bandwidth_gbps=link_bw * 8 / 1e9)
    res = plan_search(graph, est, tb, schemes=_SCHEMES, allow_fusion=True,
                      objective=objective, latency_bound_s=latency_bound_s)

    by_name = {}
    for layer, (scheme, _mode) in zip(graph.layers, res.plan.steps):
        by_name[layer.name] = "tp" if scheme == Scheme.OUTC else "sp"

    moe_mode = "ep"
    if cfg.moe and cfg.moe.n_experts % m != 0:
        moe_mode = "tp"
    return Strategy(attn=by_name.get("attn", "sp"),
                    ffn=by_name.get("ffn", "tp"),
                    moe=moe_mode,
                    fsdp=True,
                    decode_resident=resident)


def _param_bytes_estimate(cfg) -> float:
    d, L = cfg.d_model, cfg.n_layers
    per = 0.0
    if cfg.family in ("dense", "vlm"):
        per = (2 * d * cfg.n_heads * cfg.hd + 2 * d * cfg.n_kv * cfg.hd
               + 3 * d * cfg.d_ff)
    elif cfg.family == "moe":
        mo = cfg.moe
        per = 3 * d * mo.d_ff_expert * (mo.n_experts + mo.n_shared)
        if cfg.mla:
            mla = cfg.mla
            per += (d * mla.q_lora + d * mla.kv_lora
                    + mla.kv_lora * cfg.n_heads * 256)
    elif cfg.family == "ssm":
        per = 6 * d * d + 2 * d * cfg.d_ff
    elif cfg.family == "hybrid":
        per = 3 * d * cfg.ssm.expand * d
    elif cfg.family == "encdec":
        per = 2 * (4 * d * d + 2 * d * cfg.d_ff)
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    return (emb + L * per) * 2.0    # bf16
