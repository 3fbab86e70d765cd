"""Assigned architecture pool — exact configs with source citations (a
copy of the JAX package's ``configs/registry.py``).

Every entry follows the assignment block verbatim; bracketed citations are
the public sources.  ``get_config(arch_id)`` is the single lookup the
serving launcher and the tests use (``--arch <id>``).
"""
from __future__ import annotations

from typing import Callable, Dict

from .base import MLAConfig, MoEConfig, ModelConfig, SSMConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def _register(fn: Callable[[], ModelConfig]) -> Callable[[], ModelConfig]:
    cfg = fn()
    _REGISTRY[cfg.name] = fn
    return fn


@_register
def zamba2_1p2b() -> ModelConfig:
    # [arXiv:2411.15242] Mamba2 backbone + shared attention block
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
        n_heads=32, n_kv=32, d_ff=8192, vocab=32000,
        ssm=SSMConfig(kind="mamba2", d_state=64, d_conv=4, expand=2,
                      head_dim=64),
        hybrid_attn_every=6, attn_window=4096)


@_register
def granite_moe() -> ModelConfig:
    # [hf:ibm-granite/granite-3.0-1b-a400m-base] scaled per assignment line
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
        n_heads=24, n_kv=8, d_ff=512, vocab=49155,
        moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512))


@_register
def deepseek_v2() -> ModelConfig:
    # [arXiv:2405.04434] MLA kv_lora=512, 2 shared + 160 routed top-6
    return ModelConfig(
        name="deepseek-v2-236b", family="moe", n_layers=60, d_model=5120,
        n_heads=128, n_kv=128, d_ff=1536, vocab=102400, head_dim=128,
        mla=MLAConfig(kv_lora=512, q_lora=1536, qk_nope=128, qk_rope=64,
                      v_head=128),
        moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2,
                      first_dense=1, d_ff_dense=12288))


@_register
def whisper_small() -> ModelConfig:
    # [arXiv:2212.04356] enc-dec; conv frontend is a stub (frame embeddings)
    return ModelConfig(
        name="whisper-small", family="encdec", n_layers=12, d_model=768,
        n_heads=12, n_kv=12, d_ff=3072, vocab=51865, norm="layernorm",
        act="gelu", rope_kind="none", n_enc_layers=12, enc_seq=1500)


@_register
def qwen2_72b() -> ModelConfig:
    # [arXiv:2407.10671] GQA with QKV bias
    return ModelConfig(
        name="qwen2-72b", family="dense", n_layers=80, d_model=8192,
        n_heads=64, n_kv=8, d_ff=29568, vocab=152064, qkv_bias=True)


@_register
def qwen2p5_14b() -> ModelConfig:
    # [hf:Qwen/Qwen2.5-0.5B family] GQA, QKV bias
    return ModelConfig(
        name="qwen2.5-14b", family="dense", n_layers=48, d_model=5120,
        n_heads=40, n_kv=8, d_ff=13824, vocab=152064, qkv_bias=True)


@_register
def qwen2_vl_7b() -> ModelConfig:
    # [arXiv:2409.12191] M-RoPE; ViT frontend is a stub (patch embeddings)
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm", n_layers=28, d_model=3584,
        n_heads=28, n_kv=4, d_ff=18944, vocab=152064, qkv_bias=True,
        rope_kind="mrope", mrope_sections=(16, 24, 24), vision_tokens=1024)


@_register
def llama3_8b() -> ModelConfig:
    # [arXiv:2407.21783] GQA, 128k vocab
    return ModelConfig(
        name="llama3-8b", family="dense", n_layers=32, d_model=4096,
        n_heads=32, n_kv=8, d_ff=14336, vocab=128256, rope_theta=500000.0)


@_register
def olmo_1b() -> ModelConfig:
    # [arXiv:2402.00838] non-parametric LayerNorm
    return ModelConfig(
        name="olmo-1b", family="dense", n_layers=16, d_model=2048,
        n_heads=16, n_kv=16, d_ff=8192, vocab=50304, norm="nonparam_ln",
        tie_embeddings=True)


@_register
def rwkv6_3b() -> ModelConfig:
    # [arXiv:2404.05892] Finch: data-dependent decay, attention-free
    return ModelConfig(
        name="rwkv6-3b", family="ssm", n_layers=32, d_model=2560,
        n_heads=0, n_kv=0, d_ff=8960, vocab=65536, rope_kind="none",
        ssm=SSMConfig(kind="rwkv6", head_dim=64))


ARCH_IDS = tuple(sorted(_REGISTRY))


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; known: {ARCH_IDS}")
    return _REGISTRY[arch_id]()
