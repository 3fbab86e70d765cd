"""The port's decode on the mesh executor (``DecodeSession(...,
ExecConfig(executor="mesh"))``) against the JAX package's local
``DecodeSession`` and ``reference_decode`` and the port's local session.

The JAX mesh decode fails on this JAX version (ROADMAP queue C), so it is
never the reference here.  Sizes and tolerances are the reference's own
(tests/test_decode.py): tokens identical, logits within rtol = atol =
1e-4.  On the CPU the nodes run one after another and the port's pools
after a run are bit-equal to its local session's.
"""
import functools

import numpy as np
import pytest
import torch

from repro.core import Testbed as JTestbed
from repro.runtime.decode import DecodeSession as JDecodeSession
from repro.runtime.decode import TransformerSpec as JSpec
from repro.runtime.decode import greedy_decode as j_greedy_decode
from repro.runtime.decode import init_transformer as j_init_transformer
from repro.runtime.decode import plan_decode as j_plan_decode
from repro.runtime.decode import reference_decode as j_reference_decode
from repro.runtime.session import ExecConfig as JExecConfig

from repro_torch import (DecodeSession, ExecConfig, Mode, Plan, Scheme,
                         TransformerSpec, greedy_decode, init_transformer,
                         make_nodes_mesh, plan_decode, reference_decode,
                         transformer_weights_from_numpy)
from repro_torch import Testbed as TorchTestbed

SPEC = TransformerSpec(n_layers=2, d_model=256, n_heads=8, d_ff=1024,
                       vocab=64)
J_SPEC = JSpec(n_layers=2, d_model=256, n_heads=8, d_ff=1024, vocab=64)
PROMPT = [3, 17, 42, 7]
N_NEW = 5
KW = dict(page_size=4, capacity=32)
#: ATTN and FFN alternately OutC and replicated
MIXED = ((Scheme.INH, Mode.T), (Scheme.OUTC, Mode.T),
         (Scheme.OUTC, Mode.T), (Scheme.INH, Mode.T))


@functools.lru_cache(maxsize=None)
def oracle():
    """JAX weights (seed 1), the port's copy on the CPU, and the JAX
    oracle's tokens and logits."""
    wj = j_init_transformer(J_SPEC, seed=1)
    toks, lg = j_reference_decode(J_SPEC, wj, PROMPT, N_NEW)
    wnp = {"emb": np.asarray(wj["emb"]),
           "blocks": [{k: np.asarray(a) for k, a in blk.items()}
                      for blk in wj["blocks"]]}
    return wj, transformer_weights_from_numpy(wnp, "cpu"), toks, \
        np.asarray(lg)


def _close(lg, ref):
    np.testing.assert_allclose(np.asarray(lg), ref, rtol=1e-4, atol=1e-4)


def _session(plan, nodes, executor, backend, **kw):
    return DecodeSession(SPEC, oracle()[1], plan, nodes, ExecConfig(
        backend=backend, executor=executor, device="cpu"), **KW, **kw)


def _check_against_local(plan, nodes, backend):
    """The mesh session's tokens, logits and pools against the port's
    local session on the same plan; returns its tokens and logits."""
    mesh = _session(plan, nodes, "mesh", backend)
    local = _session(plan, nodes, "local", backend)
    assert mesh.mesh.shape == {"nodes": nodes}
    assert mesh.mesh.streams == ()          # no streams on the CPU
    toks, lg = greedy_decode(mesh, PROMPT, N_NEW)
    toks_l, lg_l = greedy_decode(local, PROMPT, N_NEW)
    assert toks == toks_l
    assert torch.equal(lg, lg_l)
    for i in range(SPEC.n_layers):
        for n in range(nodes):
            for a, b in zip(mesh.cache.pages(i, n), local.cache.pages(i, n)):
                assert torch.equal(a, b), (i, n)
    return toks, lg


@pytest.mark.parametrize("nodes", [1, 2, 4, 8])
def test_mesh_decode_matches_jax_session_and_oracle(nodes):
    """Searched plan at max(nodes, 2), as tests/test_decode.py does: the
    mesh session under both backends gives the tokens of the JAX local
    DecodeSession, the JAX oracle and the port's reference_decode."""
    wj, wt, ref_toks, ref_lg = oracle()
    n_plan = max(nodes, 2)
    tb = dict(bandwidth_gbps=5.0, link_latency_us=1.0)
    pj = j_plan_decode(J_SPEC, 2048, n_plan,
                       tb=JTestbed(nodes=n_plan, **tb)).plan
    pt = plan_decode(SPEC, 2048, n_plan,
                     tb=TorchTestbed(nodes=n_plan, **tb)).plan
    toks_j, lg_j = j_greedy_decode(
        JDecodeSession(J_SPEC, wj, pj, nodes, JExecConfig(), **KW),
        PROMPT, N_NEW)
    toks_r, _ = reference_decode(SPEC, wt, PROMPT, N_NEW)
    for backend in ("torch", "cuda"):
        toks, lg = _check_against_local(pt, nodes, backend)
        assert toks == toks_j == ref_toks == toks_r, backend
        _close(lg, ref_lg)
        _close(lg, np.asarray(lg_j))


@pytest.mark.parametrize("nodes", [2, 4])
def test_mesh_decode_mixed_plan_replicated_layers(nodes):
    """Replicated ATTN in block 0 and replicated FFN in block 1: every
    node computes the replicated layer and writes its own pools."""
    _, _, ref_toks, ref_lg = oracle()
    for backend in ("torch", "cuda"):
        toks, lg = _check_against_local(Plan(MIXED), nodes, backend)
        assert toks == ref_toks, backend
        _close(lg, ref_lg)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_property_mesh_decode(seed):
    """tests/test_decode.py's property case on the mesh: random geometry,
    page size, prompt, node count and mixed plan against the JAX oracle."""
    rng = np.random.default_rng(seed)
    H = int(rng.choice([1, 2, 4, 6]))
    hd = int(rng.choice([4, 8]))
    kw = dict(n_layers=int(rng.integers(1, 3)), d_model=H * hd, n_heads=H,
              d_ff=int(rng.choice([16, 32])), vocab=32)
    spec, jspec = TransformerSpec(**kw), JSpec(**kw)
    page_size = int(rng.integers(1, 6))
    prompt = [int(t) for t in rng.integers(0, spec.vocab, rng.integers(1, 6))]
    n_new = int(rng.integers(1, 5))
    nodes = int(rng.integers(2, 6))
    total = len(prompt) + n_new
    ref_toks, ref_lg = j_reference_decode(
        jspec, j_init_transformer(jspec, seed=seed), prompt, n_new)
    steps = []
    for _ in range(spec.n_layers):
        steps.append((Scheme.OUTC if rng.random() < 0.75 else Scheme.INH,
                      Mode.T))
        steps.append((Scheme.OUTC if rng.random() < 0.5 else Scheme.INH,
                      Mode.T))
    sess = DecodeSession(spec, init_transformer(spec, seed=seed,
                                                device="cpu"),
                         Plan(tuple(steps)), nodes,
                         ExecConfig(executor="mesh", device="cpu"),
                         page_size=page_size,
                         capacity=total + int(rng.integers(0, 7)),
                         cache_seed=seed + 1)
    toks, lg = greedy_decode(sess, prompt, n_new)
    assert toks == ref_toks, (seed, spec, nodes)
    _close(lg, np.asarray(ref_lg))


def test_mesh_argument_validation():
    """A mesh of another node count or device is refused; the local
    executor builds none."""
    plan = Plan(MIXED)
    with pytest.raises(ValueError, match="mesh must be 1-D"):
        _session(plan, 4, "mesh", "torch", mesh=make_nodes_mesh(2, ["cpu"]))
    with pytest.raises(ValueError, match="the mesh lies on meta"):
        _session(plan, 2, "mesh", "torch", mesh=make_nodes_mesh(2, ["meta"]))
    mesh = make_nodes_mesh(4, ["cpu"])
    assert _session(plan, 4, "mesh", "torch", mesh=mesh).mesh is mesh
    assert _session(plan, 4, "local", "torch").mesh is None
