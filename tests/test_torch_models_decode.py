"""The port's KV-cache decode (``Model.decode_step``), its serving launcher
(``repro_torch.launch.serve``) and its step functions against the JAX
package's, on CPU tensors.

Each step's logits are held against the reference's jitted
``decode_step`` on its own cache (f32: 1e-4 of scale; bf16: 2e-2).  The
port's GQA decode runs the paged decode kernel's plain version here, the
cache ``[B, KV, cap, hd]`` viewed as its page pool through an identity
table, grouped query heads by index.  The reference's own contract, decode
equal to the teacher-forced forward within 1e-3 (``tests/test_models.py``),
is held on the port too, and so is the sliding-window ring buffer.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS as J_ARCH_IDS
from repro.configs.registry import get_config as j_get_config
from repro.models.transformer import Model as JModel

from repro_torch.configs.registry import get_config
from repro_torch.launch import serve
from repro_torch.models.attention import page_size, page_table
from repro_torch.models.transformer import Model
from repro_torch.runtime.steps import make_decode_step, make_prefill_step

from torch_lm_cases import (B, BF16_ARCHS, BF16_TOL, F32_TOL, batches,
                            carried, configs, one_intra_op_thread,
                            params_to_numpy, rel_err)  # noqa: F401

SEQ = 10                # the reference's decode test length


def _decode_both(jc, pc, steps=SEQ, capacity=None, seed=0, tokens=None):
    """Both packages decode the same tokens on carried weights; returns
    (port logits, reference logits) per step, as [B, V] arrays."""
    jm, params, pm = carried(jc, pc, seed)
    jb, tb = batches(jc, s=steps, seed=seed, tokens=tokens)
    cap = capacity or jc.attn_window or steps
    jcache, pcache = jm.cache_init(B, cap), pm.cache_init(B, cap)
    if jc.family == "encdec":
        jcache["xlayers"] = jm.encode_cross(params, jb["audio_embeds"])
        pcache["xlayers"] = pm.encode_cross(tb["audio_embeds"])
    jstep = jax.jit(jm.decode_step)
    out = []
    for t in range(steps):
        jl, jcache = jstep(params, jcache, jb["tokens"][:, t:t + 1],
                           jnp.int32(t))
        pl, pcache = pm.decode_step(pcache, tb["tokens"][:, t:t + 1], t)
        assert pl.shape == (B, 1, jc.vocab)
        out.append((pl[:, 0], np.asarray(jl[:, 0], np.float32)))
    return out


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_decode_steps_match_the_reference_f32(arch):
    errs = [rel_err(p, j) for p, j in _decode_both(*configs(arch))]
    assert max(errs) < F32_TOL, errs


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_decode_steps_match_the_reference_bf16(arch):
    errs = [rel_err(p, j) for p, j in
            _decode_both(*configs(arch, dtype="bfloat16"))]
    assert max(errs) < BF16_TOL, errs


@pytest.mark.parametrize("n_kv", [2, 1])
def test_grouped_query_decode(n_kv):
    errs = [rel_err(p, j) for p, j in
            _decode_both(*configs("llama3-8b", n_kv=n_kv))]
    assert max(errs) < F32_TOL, errs


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_decode_equals_the_forward(arch):
    """The reference's decode contract on the port alone (its own seeded
    weights): drop-free MoE, a vlm continuing its text stream."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    if cfg.family == "vlm":
        cfg = dataclasses.replace(cfg, vision_tokens=0)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    _, tb = batches(cfg, s=SEQ)
    if cfg.family == "vlm":
        tb["vision_embeds"] = torch.zeros((B, 0, cfg.d_model))
    full = make_prefill_step(model)(tb)
    step = make_decode_step(model)
    cache = model.cache_init(B, capacity=cfg.attn_window or SEQ)
    if cfg.family == "encdec":
        cache["xlayers"] = model.encode_cross(tb["audio_embeds"])
    errs = []
    for t in range(SEQ):
        logits, cache = step(cache, tb["tokens"][:, t:t + 1], t)
        errs.append(float((logits[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < 1e-3, errs


@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-1.2b"])
def test_sliding_window_ring_buffer(arch):
    """Window 4 on a 4-key cache over 12 tokens: every step equals the
    reference's, and the last one the port's own windowed forward."""
    jc, pc = configs(arch, attn_window=4)
    steps = _decode_both(jc, pc, steps=12, capacity=4)
    assert max(rel_err(p, j) for p, j in steps) < F32_TOL
    model = carried(jc, pc)[2]
    _, tb = batches(jc, s=12)
    full = model.forward(tb)[0]
    assert float((steps[-1][0] - full[:, -1]).abs().max()) < 1e-3


def test_page_size_divides_any_capacity():
    assert [page_size(c) for c in (1, 4, 10, 11, 16, 17, 24, 32, 4096)] \
        == [1, 4, 10, 11, 16, 1, 12, 16, 16]
    for cap in range(1, 70):
        ps = page_size(cap)
        assert cap % ps == 0 and ps <= 16
        assert page_table(cap, "cpu").tolist() == list(range(cap // ps))


@pytest.mark.parametrize("capacity", [10, 17])
def test_decode_on_an_odd_capacity(capacity):
    """The reference's capacity of 10 (one page of 10 keys) and a prime
    above the page size (pages of one key): still the reference's."""
    jc, pc = configs("llama3-8b", n_kv=2)
    errs = [rel_err(p, j) for p, j in
            _decode_both(jc, pc, steps=SEQ, capacity=capacity)]
    assert max(errs) < F32_TOL, errs


def test_decode_past_the_cache_raises():
    """With no window, position ``capacity`` has no slot: the port raises,
    where the reference's ``dynamic_update_slice`` clamps the write into
    the last slot and decodes on (a divergence kept on purpose, ROADMAP
    C)."""
    jc, pc = configs("llama3-8b")
    jm, params, model = carried(jc, pc)
    cache = model.cache_init(1, 2)
    tok = torch.zeros((1, 1), dtype=torch.long)
    model.decode_step(cache, tok, 1)
    with pytest.raises(ValueError, match="outside a cache of 2"):
        model.decode_step(cache, tok, 2)
    jcache = jm.cache_init(1, 2)
    for t in range(3):
        logits, jcache = jm.decode_step(params, jcache,
                                        jnp.zeros((1, 1), jnp.int32),
                                        jnp.int32(t))
    assert bool(jnp.isfinite(logits).all())


def test_serve_tokens_equal_a_greedy_reference_loop():
    """``serve.main`` on the CPU in f32: its greedy tokens equal those of
    a greedy loop over the reference's ``decode_step`` on the same weights
    (carried back with ``params_to_numpy``) and prompts."""
    res = serve.main(["--arch", "llama3-8b", "--device", "cpu", "--dtype",
                      "float32", "--batch", "2", "--prompt-len", "6",
                      "--gen", "8"])
    assert res.tokens.shape == (2, 8) and len(res.step_logits) == 14
    jcfg = dataclasses.replace(j_get_config("llama3-8b").reduced(),
                               dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(res.model.cfg)
    jm = JModel(jcfg)
    params = params_to_numpy(res.model)
    step = jax.jit(jm.decode_step)
    prompts = jnp.asarray(res.prompts.numpy(), jnp.int32)
    cache = jm.cache_init(2, 14)
    errs = []
    for t in range(6):
        logits, cache = step(params, cache, prompts[:, t:t + 1],
                             jnp.int32(t))
        errs.append(rel_err(res.step_logits[t], logits[:, -1]))
    tok = jnp.argmax(logits[:, -1], axis=-1, keepdims=True)
    out = []
    for i in range(8):
        out.append(tok)
        logits, cache = step(params, cache, tok, jnp.int32(6 + i))
        errs.append(rel_err(res.step_logits[6 + i], logits[:, -1]))
        tok = jnp.argmax(logits[:, -1], axis=-1, keepdims=True)
    assert np.array_equal(res.tokens.numpy(),
                          np.asarray(jnp.concatenate(out, axis=1)))
    assert max(errs) < F32_TOL, errs


@pytest.mark.parametrize("arch", ["whisper-small", "qwen2-vl-7b",
                                  "rwkv6-3b"])
def test_serve_runs_every_family_kind(arch):
    res = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "3", "--gen", "2"])
    assert res.tokens.shape == (2, 2)
    assert res.model.tok_emb.dtype == torch.bfloat16
    assert res.decode_ms_per_token > 0


def test_serve_dry_run_and_missing_card_raise():
    # --dry-run counts the production-mesh decode step (no card needed)
    (rec,) = serve.main(["--arch", "llama3-8b", "--dry-run"])
    assert (rec["arch"], rec["shape"], rec["mesh"]) == ("llama3-8b",
                                                        "decode_32k",
                                                        "16x16")
    assert rec["hlo_flops"] > 0 and rec["bottleneck"] == "memory"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            serve.main(["--arch", "llama3-8b", "--batch", "1",
                        "--prompt-len", "1", "--gen", "1"])
