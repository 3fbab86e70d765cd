"""The LM decode step as one program (``runtime.steps.capture_decode_step``)
against the int-position step and the reference's
``jax.jit(Model(cfg).decode_step)``, on CPU tensors.

On the CPU a program runs the step eagerly on its own tensors, the token
``[B, 1]`` and the position as a 0-d int32, so these tests run the body
that the card captures: every slot write, live length and rotary
coordinate read from a tensor.  Held here:

* the program's tokens and every step's logits bit-equal to the
  int-position step's (``serve.generate(..., eager=True)``) for all ten
  registry archs, and within 1e-4 of scale of the reference's jitted
  ``decode_step`` called with ``jnp.int32(t)`` on the carried weights;
* a windowed arch across the wrap of its ring buffer;
* a position past a no-window cache raising ``ValueError`` before any
  write (the divergence from the reference kept on purpose, ROADMAP C);
* MoE's dispatch into a spare row bit-equal to the masked scatter it
  replaced, with tokens dropped.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.registry import ARCH_IDS as J_ARCH_IDS

from repro_torch.launch import serve
from repro_torch.models import ffn
from repro_torch.models.transformer import Model
from repro_torch.runtime.steps import capture_decode_step

from torch_lm_cases import (B, F32_TOL, batches, carried, configs,
                            one_intra_op_thread, rel_err)  # noqa: F401

PROMPT, GEN = 4, 5


def _serve_both(jc, pc, prompt=PROMPT, gen=GEN, capacity=None):
    """The port's program and eager serve runs on the carried weights, and
    the reference's jitted step fed the same tokens: (program result,
    eager result, reference logits per step as [B, V] arrays)."""
    jm, params, pm = carried(jc, pc)
    jb, tb = batches(jc, s=prompt)
    audio = tb.get("audio_embeds")
    runs = [serve.generate(pm, tb["tokens"], gen, audio, eager=eager)
            for eager in (False, True)]
    cap = capacity or jc.attn_window or (prompt + gen)
    jcache = jm.cache_init(B, cap)
    if jc.family == "encdec":
        jcache["xlayers"] = jm.encode_cross(params, jb["audio_embeds"])
    toks = torch.cat([tb["tokens"], runs[0].tokens], dim=1).numpy()
    jstep = jax.jit(jm.decode_step)
    ref = []
    for t in range(prompt + gen):
        jl, jcache = jstep(params, jcache, jnp.asarray(toks[:, t:t + 1],
                                                        jnp.int32),
                           jnp.int32(t))
        ref.append(np.asarray(jl[:, 0], np.float32))
    return runs[0], runs[1], ref


def _hold(prog, eager, ref):
    assert torch.equal(prog.tokens, eager.tokens)
    assert len(prog.step_logits) == len(eager.step_logits) == len(ref)
    for a, b in zip(prog.step_logits, eager.step_logits):
        assert torch.equal(a, b)
    errs = [rel_err(p, j) for p, j in zip(prog.step_logits, ref)]
    assert max(errs) < F32_TOL, errs


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_program_decode_equals_the_int_step_and_the_reference(arch):
    jc, pc = configs(arch)
    if pc.family == "vlm":          # serving's text stream
        jc, pc = configs(arch, vision_tokens=0)
    _hold(*_serve_both(jc, pc))


@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-1.2b"])
def test_program_decode_wraps_the_ring_buffer(arch):
    """Window 4 on a 4-key cache over 3 + 9 tokens: the device slot
    ``t % 4`` wraps twice."""
    jc, pc = configs(arch, attn_window=4)
    _hold(*_serve_both(jc, pc, prompt=3, gen=9, capacity=4))


def test_program_position_past_the_cache_raises_before_any_write():
    jc, pc = configs("llama3-8b")
    model = carried(jc, pc)[2]
    cache = model.cache_init(1, 2)
    prog = capture_decode_step(model, cache, 1)
    tok = torch.zeros((1, 1), dtype=torch.long)
    prog(cache, tok, 0)
    prog(cache, tok, 1)
    before = [c[n].clone() for c in cache["layers"] for n in ("k", "v")]
    for t in (2, -1):
        with pytest.raises(ValueError, match="outside a cache of 2"):
            prog(cache, tok, t)
    after = [c[n] for c in cache["layers"] for n in ("k", "v")]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    with pytest.raises(ValueError, match="cache it was made on"):
        prog(model.cache_init(1, 2), tok, 0)


def test_the_int_step_checks_before_the_first_layer_writes():
    """A hybrid's Mamba2 layers come before its attention layer: the
    int-position step raises before any of them writes its state."""
    jc, pc = configs("zamba2-1.2b", attn_window=None)
    model = carried(jc, pc)[2]
    cache = model.cache_init(1, 2)
    tok = torch.zeros((1, 1), dtype=torch.long)
    model.decode_step(cache, tok, 1)
    states = [s.clone() for c in cache["layers"] for s in c.values()]
    with pytest.raises(ValueError, match="outside a cache of 2"):
        model.decode_step(cache, tok, 2)
    assert all(torch.equal(a, b) for a, b in zip(
        states, [s for c in cache["layers"] for s in c.values()]))


def _masked_moe(cfg, p, x):
    """The dispatch the port had before, a boolean-mask scatter
    (``buf[slot[keep]] = src[keep]``): the yardstick of the spare row."""
    m = cfg.moe
    Bx, S, d = x.shape
    T, E, K, G = Bx * S, m.n_experts, m.top_k, Bx
    xt = x.reshape(G, S, d)
    probs = torch.softmax(xt.float() @ p.router, dim=-1)
    gate, idx = ffn.top_k(probs, K)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    C = max(1, int(S * K * m.capacity_factor / E))
    flat_e = idx.reshape(G, S * K)
    onehot = F.one_hot(flat_e, E)
    pos_in_e = torch.cumsum(onehot, dim=1) - onehot
    pos = pos_in_e.gather(2, flat_e[..., None])[..., 0]
    keep = (pos < C).reshape(-1)
    gidx = torch.arange(G)[:, None]
    slot = (flat_e * (G * C) + gidx * C
            + torch.clamp(pos, max=C - 1)).reshape(-1)
    src = xt.repeat_interleave(K, dim=1).reshape(-1, d)
    buf = torch.zeros((E * G * C, d), dtype=x.dtype)
    buf[slot[keep]] = src[keep]
    ebuf = buf.reshape(E, G * C, d)
    h = F.silu(torch.einsum("ecd,edf->ecf", ebuf, p.w_gate)) \
        * torch.einsum("ecd,edf->ecf", ebuf, p.w_up)
    y = torch.einsum("ecf,efd->ecd", h, p.w_down).reshape(E * G * C, d)
    gathered = torch.where(keep[:, None], y[slot], 0.0)
    w = gate.reshape(-1)[:, None].to(x.dtype)
    out = (gathered * w).reshape(T, K, d).sum(dim=1).reshape(Bx, S, d)
    if m.n_shared:
        out = out + ffn.mlp(cfg, p.shared, x)
    return out, int((~keep).sum())


@pytest.mark.parametrize("arch,factor", [("granite-moe-3b-a800m", 0.5),
                                         ("deepseek-v2-236b", 0.5),
                                         ("granite-moe-3b-a800m", None)])
def test_moe_spare_row_equals_the_masked_scatter(arch, factor):
    """At a capacity factor of 0.5 (and the config's own) the spare-row
    scatter gives the masked scatter's bits, tokens dropped included."""
    cfg = configs(arch)[1]
    if factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=factor))
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    p = next(b.moe for b in model.blocks)
    x = torch.randn((3, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(4))
    want, dropped = _masked_moe(cfg, p, x)
    got, _ = ffn.moe(cfg, p, x)
    assert torch.equal(got, want)
    if factor is not None:
        assert dropped > 0
