"""The port's LM substrate (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package's, on CPU tensors: configs, the full forward, the
loss, and the carry of the reference's weights.

Weights come from the reference's ``Model(cfg).init(PRNGKey(seed))``,
carried by ``params_from_numpy``; tokens and embeddings from numpy.  The
port's self-attention runs the flash kernel's plain version here (the
wrapper's CPU dispatch), MoE, MLA and the SSMs plain torch.  Tolerances:
f32 logits within 1e-4 of their scale, bf16 within 2e-2 (the reference's
two bounds).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS as J_ARCH_IDS
from repro.configs.registry import get_config as j_get_config
from repro.models import attention as JA
from repro.models import ffn as JF

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models.transformer import Model, params_from_numpy

from torch_lm_cases import (BF16_ARCHS, BF16_TOL, F32_TOL, batches, carried,
                            configs, one_intra_op_thread, params_to_numpy,
                            rel_err, to_numpy)  # noqa: F401 (autouse)


def test_registry_matches_the_reference():
    assert ARCH_IDS == J_ARCH_IDS and len(ARCH_IDS) == 10
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2")


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_config_fields_equal_the_reference(arch):
    full, ref = get_config(arch), j_get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(ref)
    assert dataclasses.asdict(full.reduced()) == \
        dataclasses.asdict(ref.reduced())
    if ref.n_heads:                       # rwkv6 has no attention heads
        assert full.hd == ref.hd and full.reduced().hd == ref.reduced().hd


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_forward_and_loss_match_f32(arch):
    jc, pc = configs(arch)
    jm, params, pm = carried(jc, pc)
    jb, tb = batches(jc)
    jl, ja = jm.forward(params, jb)
    pl, pa = pm.forward(tb)
    assert pl.shape == jl.shape and pl.dtype == torch.float32
    assert rel_err(pl, jl) < F32_TOL
    assert rel_err(pa, ja) < F32_TOL
    lj, lp = float(jm.loss(params, jb)), float(pm.loss(tb))
    assert abs(lp - lj) <= F32_TOL * abs(lj)
    assert torch.equal(pm.prefill(tb), pl)


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_forward_matches_bf16(arch):
    jc, pc = configs(arch, dtype="bfloat16")
    jm, params, pm = carried(jc, pc)
    jb, tb = batches(jc)
    jl, _ = jm.forward(params, jb)
    pl, _ = pm.forward(tb)
    assert pl.dtype == torch.bfloat16
    assert rel_err(pl, np.asarray(jl, np.float32)) < BF16_TOL


@pytest.mark.parametrize("n_kv", [2, 1])
def test_grouped_query_heads_forward(n_kv):
    """llama3-8b reduced with 4 query heads over 2 or 1 KV heads: the flash
    path reads each KV head for its group by index."""
    jc, pc = configs("llama3-8b", n_kv=n_kv)
    jm, params, pm = carried(jc, pc)
    jb, tb = batches(jc)
    assert rel_err(pm.forward(tb)[0], jm.forward(params, jb)[0]) < F32_TOL


def test_long_prefill_takes_the_chunked_range():
    """S = 2048 (the reference's ``_chunked_sdpa`` from
    ``CHUNKED_SEQ_THRESHOLD`` on); the port runs the flash path at every
    length."""
    assert JA.CHUNKED_SEQ_THRESHOLD == 2048
    jc, pc = configs("llama3-8b")
    jm, params, pm = carried(jc, pc)
    jb, tb = batches(jc, b=1, s=2048)
    assert rel_err(pm.forward(tb)[0], jm.forward(params, jb)[0]) < F32_TOL


def test_moe_default_capacity_drops_the_same_tokens():
    """granite-moe reduced at its default capacity factor 1.25, with one
    batch row of a repeated token so its two experts overflow: both
    packages drop the same assignments (ties of the router broken to the
    lower index on both), and the port's output differs from a drop-free
    one."""
    jc, pc = configs("granite-moe-3b-a800m")
    jm, params, pm = carried(jc, pc)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, jc.d_model)).astype(np.float32)
    x[0] = x[0, :1]                       # 16 copies of one token
    p0 = jax.tree.map(lambda a: a[0], params["blocks"])["moe"]
    jo, jaux = JF.moe(jc, p0, jnp.asarray(x))
    po, paux = F.moe(pc, pm.blocks[0].moe, torch.from_numpy(x))
    assert rel_err(po, jo) < F32_TOL and rel_err(paux, jaux) < F32_TOL
    free, _ = F.moe(pc, pm.blocks[0].moe, torch.from_numpy(x),
                    capacity=16 * pc.moe.top_k)
    assert not torch.allclose(free[0], po[0])
    tokens = np.stack([np.full(16, 7), np.arange(16)])
    jb, tb = batches(jc, tokens=tokens)
    assert rel_err(pm.forward(tb)[0], jm.forward(params, jb)[0]) < F32_TOL


def test_top_k_breaks_ties_to_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]])
    gate, idx = F.top_k(probs, 2)
    assert idx.tolist() == [[0, 1], [1, 2]]
    jg, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(ji).tolist()
    assert torch.equal(gate, torch.from_numpy(np.array(jg)))


def test_deepseek_mla_with_a_first_dense_layer():
    """deepseek-v2 reduced: one leading dense layer (its own d_ff) before
    the MoE layers, MLA attention in both; ``mla_full`` alone against the
    reference's, then the whole model's forward (above) covers the rest."""
    jc, pc = configs("deepseek-v2-236b")
    jm, params, pm = carried(jc, pc)
    assert len(pm.first_blocks) == 1 and len(pm.blocks) == 1
    assert isinstance(pm.first_blocks[0].attn, A.MLA)
    assert pm.first_blocks[0].mlp.w_up.shape[1] == pc.moe.d_ff_dense
    x = (np.random.default_rng(4).standard_normal((2, 16, jc.d_model))
         * 0.5).astype(np.float32)
    p0 = jax.tree.map(lambda a: a[0], params["first_blocks"])["attn"]
    jo = JA.mla_full(jc, p0, jnp.asarray(x))
    po = A.mla_full(pc, pm.first_blocks[0].attn, torch.from_numpy(x))
    assert rel_err(po, jo) < F32_TOL
    jw = JA.mla_full(jc, p0, jnp.asarray(x), window=4)
    pw = A.mla_full(pc, pm.first_blocks[0].attn, torch.from_numpy(x),
                    window=4)
    assert rel_err(pw, jw) < F32_TOL


def test_params_from_numpy_refuses_a_missing_or_extra_leaf():
    jc, pc = configs("llama3-8b")
    _, params, _ = carried(jc, pc)
    tree = to_numpy(params)
    missing = dict(tree, blocks=dict(tree["blocks"]))
    missing["blocks"]["attn"] = dict(tree["blocks"]["attn"])
    del missing["blocks"]["attn"]["wq"]
    with pytest.raises(ValueError, match=r"no leaf \['blocks.0.attn.wq'"):
        params_from_numpy(pc, missing, "cpu")
    extra = dict(tree, lm_bias=np.zeros(pc.vocab, np.float32))
    with pytest.raises(ValueError, match=r"no parameter \['lm_bias'\]"):
        params_from_numpy(pc, extra, "cpu")
    wrong = dict(tree, lm_head=tree["lm_head"].T)
    with pytest.raises(ValueError, match="lm_head: leaf shape"):
        params_from_numpy(pc, wrong, "cpu")
    bf = dict(tree, tok_emb=np.asarray(jnp.asarray(tree["tok_emb"],
                                                   jnp.bfloat16)))
    with pytest.raises(ValueError, match="tok_emb: leaf dtype"):
        params_from_numpy(pc, bf, "cpu")


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "olmo-1b",
                                  "deepseek-v2-236b", "whisper-small"])
def test_params_round_trip_to_the_reference_tree(arch):
    """``params_to_numpy`` gives back the reference's pytree, leaf for leaf
    and bit for bit (stacked layers, empty norm dicts, shared blocks)."""
    jc, pc = configs(arch)
    _, params, pm = carried(jc, pc)
    back = params_to_numpy(pm)
    ref = to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_bf16_carry_is_exact():
    """A bfloat16 pytree (``ml_dtypes`` arrays) lands bit for bit in
    bfloat16 parameters; the reference's f32 leaves (router, SSM
    constants) stay f32."""
    jc, pc = configs("granite-moe-3b-a800m", dtype="bfloat16")
    _, params, pm = carried(jc, pc)
    assert pm.blocks[0].moe.router.dtype == torch.float32
    assert pm.tok_emb.dtype == torch.bfloat16
    ref = np.asarray(params["tok_emb"], np.float32)
    assert np.array_equal(pm.tok_emb.float().numpy(), ref)


def test_seeded_init_has_the_reference_distributions():
    _, pc = configs("zamba2-1.2b")
    a = Model(pc, device="cpu").init(torch.Generator().manual_seed(5))
    b = Model(pc, device="cpu").init(torch.Generator().manual_seed(5))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    assert abs(float(a.tok_emb.std()) - 0.02) < 2e-3
    d = pc.d_model
    assert abs(float(a.lm_head.std()) * d ** 0.5 - 1.0) < 0.05
    m = a.blocks[0].mamba
    assert torch.equal(m.dt_bias, torch.full_like(m.dt_bias, -2.0))
    assert torch.equal(m.d_skip, torch.ones_like(m.d_skip))
    assert torch.equal(a.final_norm.w, torch.ones(d))


def test_model_on_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        Model(get_config("llama3-8b").reduced(), device="cuda")
