"""Model configuration schema for the assigned architecture pool: a copy of
the JAX package's ``configs/base.py`` (the port imports nothing of it)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0             # always-on shared experts (DeepSeek)
    first_dense: int = 0          # leading dense layers (DeepSeek layer 0)
    d_ff_dense: int = 0           # d_ff of the leading dense layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    q_lora: int = 1536
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba2"          # "mamba2" | "rwkv6"
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64            # SSM head size
    # chunk-parallel scan (0 = exact per-token recurrence).  The chunked
    # form trades per-token state IO for intra-chunk matmuls — the
    # §Perf hillclimb for the SSM/hybrid architectures.
    chunk: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"         # rmsnorm | layernorm | nonparam_ln
    act: str = "swiglu"           # swiglu | gelu
    rope_kind: str = "rope"       # rope | mrope | none | sinusoidal
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    attn_window: Optional[int] = None   # sliding-window width (decode paths)
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one shared attention block applied every N ssm blocks
    hybrid_attn_every: int = 0
    # encoder-decoder (whisper): encoder depth + fixed source length
    n_enc_layers: int = 0
    enc_seq: int = 1500
    # vlm (qwen2-vl): number of stub vision tokens prepended
    vision_tokens: int = 0
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant of the same family: <=2 layers, d_model<=512,
        <=4 experts — runs a real forward/train step on CPU."""
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv, n_heads)) if n_heads else 0
        d_model = min(self.d_model, 256)
        kw = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2),
            d_model=d_model,
            n_heads=n_heads, n_kv=n_kv,
            head_dim=d_model // n_heads if n_heads else 0,
            d_ff=min(self.d_ff, 512),
            vocab=min(self.vocab, 512),
            attn_window=min(self.attn_window, 64) if self.attn_window else None,
            mrope_sections=(16, 24, 24) if self.rope_kind == "mrope" else self.mrope_sections,
        )
        if self.rope_kind == "mrope":
            # sections must sum to hd/2
            hd = kw["d_model"] // kw["n_heads"]
            kw["mrope_sections"] = (hd // 2 - 2 * (hd // 6), hd // 6, hd // 6)
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=min(self.moe.d_ff_expert, 128),
                n_shared=min(self.moe.n_shared, 1),
                first_dense=min(self.moe.first_dense, 1),
                d_ff_dense=min(self.moe.d_ff_dense, 256) if self.moe.d_ff_dense else 0)
        if self.mla:
            kw["mla"] = MLAConfig(kv_lora=64, q_lora=64, qk_nope=32,
                                  qk_rope=16, v_head=32)
            kw["head_dim"] = 32
        if self.ssm:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=16, head_dim=32)
        if self.hybrid_attn_every:
            kw["hybrid_attn_every"] = 1
        if self.n_enc_layers:
            kw["n_enc_layers"] = 1
            kw["enc_seq"] = 16
        if self.vision_tokens:
            kw["vision_tokens"] = 8
        return dataclasses.replace(self, **kw)
