"""The port's state-space blocks (``repro_torch.models.ssm``: Mamba2 and
RWKV-6) against the JAX package's ``repro.models.ssm``, on CPU tensors.

The exact per-token recurrences, the chunk-parallel forms (chunks of 4 and
8, lengths that do and do not divide them) and the O(1)-state decode steps
take the same weights (the reference's ``init_*``, with random decays
drawn on top) and the same inputs; outputs and carried states agree within
1e-5 of their scale (f32 sums in another order), the bound the reference
holds its chunked forms to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import SSMConfig as JSSMConfig
from repro.models import ssm as JS

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.models import ssm as S

from torch_lm_cases import one_intra_op_thread, rel_err  # noqa: F401

TOL = 1e-5


def _cfgs(kind, chunk=0):
    kw = dict(name="t", n_layers=1, d_model=64, d_ff=128, vocab=64,
              dtype="float32")
    if kind == "rwkv6":
        kw.update(family="ssm", n_heads=0, n_kv=0)
        ssm = dict(kind="rwkv6", head_dim=32, chunk=chunk)
    else:
        kw.update(family="hybrid", n_heads=4, n_kv=4)
        ssm = dict(kind="mamba2", d_state=16, head_dim=32, chunk=chunk)
    return (JModelConfig(ssm=JSSMConfig(**ssm), **kw),
            ModelConfig(ssm=SSMConfig(**ssm), **kw))


def _blocks(kind, seed=0):
    """The reference's block params (random decays drawn over its init) and
    the port's module holding them."""
    jc, pc = _cfgs(kind)
    rng = np.random.default_rng(seed)
    if kind == "rwkv6":
        p = jax.tree.map(np.asarray, JS.init_rwkv6(jc, jax.random.PRNGKey(
            seed)))
        p["decay_bias"] = rng.uniform(-6, 1, p["decay_bias"].shape).astype(
            np.float32)
        p["u_bonus"] = rng.normal(0, 0.5, p["u_bonus"].shape).astype(
            np.float32)
        mod = S.RWKV6(pc, "cpu", torch.float32)
    else:
        p = jax.tree.map(np.asarray, JS.init_mamba2(jc, jax.random.PRNGKey(
            seed)))
        p["a_log"] = rng.normal(0, 1, p["a_log"].shape).astype(np.float32)
        p["dt_bias"] = rng.normal(-1, 1, p["dt_bias"].shape).astype(
            np.float32)
        mod = S.Mamba2(pc, "cpu", torch.float32)
    names = dict(mod.named_parameters())
    assert set(names) == set(p)
    with torch.no_grad():
        for name, t in names.items():
            t.copy_(torch.from_numpy(np.array(p[name])))
    return p, mod


def _x(seq, seed=1):
    return (np.random.default_rng(seed).standard_normal((2, seq, 64))
            * 0.5).astype(np.float32)


@pytest.mark.parametrize("chunk", [0, 4, 8])
@pytest.mark.parametrize("seq", [13, 16])
def test_mamba2_full_matches(chunk, seq):
    jc, pc = _cfgs("mamba2", chunk)
    p, mod = _blocks("mamba2")
    x = _x(seq)
    ref = JS.mamba2_full(jc, p, jnp.asarray(x))
    out = S.mamba2_full(pc, mod, torch.from_numpy(x))
    assert rel_err(out, ref) < TOL


@pytest.mark.parametrize("chunk", [0, 4, 8])
@pytest.mark.parametrize("seq", [13, 16])
def test_rwkv6_time_mix_matches(chunk, seq):
    jc, pc = _cfgs("rwkv6", chunk)
    p, mod = _blocks("rwkv6")
    x = _x(seq)
    ref = JS.rwkv6_time_mix(jc, p, jnp.asarray(x))
    out = S.rwkv6_time_mix(pc, mod, torch.from_numpy(x))
    assert rel_err(out, ref) < TOL
    assert rel_err(S.rwkv6_channel_mix(pc, mod, torch.from_numpy(x)),
                   JS.rwkv6_channel_mix(jc, p, jnp.asarray(x))) < TOL


@pytest.mark.parametrize("kind", ["mamba2", "rwkv6"])
@pytest.mark.parametrize("chunk", [4, 8])
def test_chunked_equals_the_exact_recurrence(kind, chunk):
    """The port's chunked forms against its own per-token recurrence (the
    reference's ``tests/test_ssm_chunked.py`` property)."""
    _, exact = _cfgs(kind)
    _, chunked = _cfgs(kind, chunk)
    _, mod = _blocks(kind, seed=2)
    x = torch.from_numpy(_x(21, seed=3))
    fn = S.mamba2_full if kind == "mamba2" else S.rwkv6_time_mix
    assert rel_err(fn(chunked, mod, x), fn(exact, mod, x).numpy()) < TOL


def test_mamba2_decode_steps_match():
    """Six O(1)-state steps: each output and the carried state (SSM state
    and conv history) equal the reference's, and the steps equal the full
    path's positions."""
    jc, pc = _cfgs("mamba2")
    p, mod = _blocks("mamba2")
    x = _x(6)
    js = JS.mamba2_state_init(jc, 2)
    ps = S.mamba2_state_init(pc, 2, torch.float32, "cpu")
    full = S.mamba2_full(pc, mod, torch.from_numpy(x))
    for t in range(6):
        jy, js = JS.mamba2_decode(jc, p, jnp.asarray(x[:, t:t + 1]), js)
        py, ps = S.mamba2_decode(pc, mod, torch.from_numpy(x[:, t:t + 1]),
                                 ps)
        assert rel_err(py, jy) < TOL
        assert rel_err(ps["h"], js["h"]) < TOL
        assert rel_err(ps["conv"], js["conv"]) < TOL
        assert rel_err(py[:, 0], full[:, t].numpy()) < TOL


def test_rwkv6_decode_steps_match():
    jc, pc = _cfgs("rwkv6")
    p, mod = _blocks("rwkv6")
    x = _x(6)
    js = JS.rwkv6_state_init(jc, 2)
    ps = S.rwkv6_state_init(pc, 2, "cpu")
    full = S.rwkv6_time_mix(pc, mod, torch.from_numpy(x))
    for t in range(6):
        jy, js = JS.rwkv6_decode(jc, p, jnp.asarray(x[:, t:t + 1]), js)
        py, ps = S.rwkv6_decode(pc, mod, torch.from_numpy(x[:, t:t + 1]),
                                ps)
        assert rel_err(py, jy) < TOL
        assert rel_err(ps["s"], js["s"]) < TOL
        assert rel_err(py[:, 0], full[:, t].numpy()) < TOL
