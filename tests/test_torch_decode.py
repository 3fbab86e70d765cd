"""The port's decode slice against the JAX package's: planner IR, seeded
weights, the paged KV cache, the single-device oracle and the sharded
``DecodeSession`` on the local executor.

Both sides get the same numpy inputs; the port runs on CPU tensors, where
``backend="cuda"`` takes the plain version of the paged decode kernel (the
kernel itself is held against it on the card in ``test_torch_gpu.py``).
Sizes and tolerances are the reference's own (tests/test_decode.py):
tokens identical, logits within rtol = atol = 1e-4.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Testbed as JTestbed
from repro.runtime.decode import DecodeSession as JDecodeSession
from repro.runtime.decode import TransformerSpec as JSpec
from repro.runtime.decode import decode_graph as j_decode_graph
from repro.runtime.decode import greedy_decode as j_greedy_decode
from repro.runtime.decode import init_transformer as j_init_transformer
from repro.runtime.decode import plan_decode as j_plan_decode
from repro.runtime.decode import prefill_graph as j_prefill_graph
from repro.runtime.decode import reference_decode as j_reference_decode
from repro.runtime.kv_cache import PagedKVCache as JPagedKVCache
from repro.runtime.session import ExecConfig as JExecConfig

from repro_torch import (DecodeSession, ExecConfig, Mode, PagedKVCache,
                         Plan, Scheme, TransformerSpec,
                         decode_graph, greedy_decode, init_transformer,
                         make_nodes_mesh, plan_decode, prefill_graph,
                         reference_decode,
                         transformer_weights_from_numpy)
from repro_torch import Testbed as TorchTestbed

SPEC = TransformerSpec(n_layers=2, d_model=256, n_heads=8, d_ff=1024,
                       vocab=64)
J_SPEC = JSpec(n_layers=2, d_model=256, n_heads=8, d_ff=1024, vocab=64)
PROMPT = [3, 17, 42, 7]
N_NEW = 5
CPU = dict(device="cpu")


def _tb(cls, nodes):
    """The reference tests' head-sharding-friendly testbed."""
    return cls(nodes=nodes, bandwidth_gbps=5.0, link_latency_us=1.0)


def _to_numpy(w):
    return {"emb": np.asarray(w["emb"]),
            "blocks": [{k: np.asarray(a) for k, a in blk.items()}
                       for blk in w["blocks"]]}


@functools.lru_cache(maxsize=None)
def oracle():
    """JAX weights (seed 1) as numpy, and the JAX oracle's tokens and
    logits."""
    wj = j_init_transformer(J_SPEC, seed=1)
    toks, lg = j_reference_decode(J_SPEC, wj, PROMPT, N_NEW)
    return wj, _to_numpy(wj), toks, np.asarray(lg)


def _close(lg, ref):
    np.testing.assert_allclose(np.asarray(lg), ref, rtol=1e-4, atol=1e-4)


def _plans(nodes):
    pj = j_plan_decode(J_SPEC, 2048, nodes, tb=_tb(JTestbed, nodes)).plan
    pt = plan_decode(SPEC, 2048, nodes, tb=_tb(TorchTestbed, nodes)).plan
    return pj, pt


# ---------------------------------------------------------------------------
# weights, page table, planner IR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_init_transformer_is_bit_equal_to_the_reference(seed):
    wj = _to_numpy(j_init_transformer(J_SPEC, seed=seed))
    wt = init_transformer(SPEC, seed=seed, device="cpu")
    assert np.array_equal(wt["emb"].numpy(), wj["emb"])
    assert len(wt["blocks"]) == len(wj["blocks"])
    for bt, bj in zip(wt["blocks"], wj["blocks"]):
        assert set(bt) == set(bj)
        for key in bj:
            assert bt[key].dtype == torch.float32
            assert np.array_equal(bt[key].numpy(), bj[key]), key
    carried = transformer_weights_from_numpy(wj, "cpu")
    assert np.array_equal(carried["blocks"][1]["w2"].numpy(),
                          wj["blocks"][1]["w2"])
    with pytest.raises(ValueError, match="block keys"):
        transformer_weights_from_numpy(
            {"emb": wj["emb"], "blocks": [{"wq": wj["blocks"][0]["wq"]}]},
            "cpu")


@pytest.mark.parametrize("seed,ps,cap", [(0, 4, 32), (3, 4, 16),
                                         (11, 16, 512), (5, 1, 9)])
def test_page_table_equals_the_reference(seed, ps, cap):
    cj = JPagedKVCache([[2, 1]], head_dim=3, page_size=ps, capacity=cap,
                       seed=seed)
    ct = PagedKVCache([[2, 1]], head_dim=3, page_size=ps, capacity=cap,
                      seed=seed, **CPU)
    assert ct.page_table.dtype == np.int32
    assert np.array_equal(ct.page_table, cj.page_table)
    assert ct.device_table.dtype == torch.int32
    assert np.array_equal(ct.device_table.numpy(), cj.page_table)
    for pos in (0, cap // 2, cap - 1):
        assert ct.slot(pos) == cj.slot(pos)


@pytest.mark.parametrize("nodes", [2, 4, 8])
def test_plan_decode_steps_equal_the_reference(nodes):
    pj, pt = _plans(nodes)
    assert [(int(s), int(m)) for s, m in pt.steps] == \
        [(int(s), int(m)) for s, m in pj.steps]
    # the reference's acceptance bar: the planner head-shards every ATTN
    assert all(s == Scheme.OUTC for s, _ in pt.steps[::2])
    rj = j_plan_decode(J_SPEC, 512, nodes)
    rt = plan_decode(SPEC, 512, nodes)
    assert rt.cost == rj.cost
    assert [int(s) for s, _ in rt.plan.steps] == \
        [int(s) for s, _ in rj.plan.steps]
    with pytest.raises(ValueError, match="testbed nodes"):
        plan_decode(SPEC, 512, nodes, tb=TorchTestbed(nodes=nodes + 1))


def test_decode_and_prefill_graph_fields_equal_the_reference():
    for gt, gj in ((decode_graph(SPEC, 512), j_decode_graph(J_SPEC, 512)),
                   (prefill_graph(SPEC, 64), j_prefill_graph(J_SPEC, 64))):
        assert gt.name == gj.name and len(gt) == len(gj)
        for lt, lj in zip(gt.layers, gj.layers):
            assert (lt.name, int(lt.conv_t), lt.in_h, lt.in_w, lt.in_c,
                    lt.out_c, lt.k, lt.s, lt.p, lt.heads) == \
                (lj.name, int(lj.conv_t), lj.in_h, lj.in_w, lj.in_c,
                 lj.out_c, lj.k, lj.s, lj.p, lj.heads)
            assert lt.extra_flop_factor == lj.extra_flop_factor
            assert lt.flops() == lj.flops()
    with pytest.raises(ValueError, match="divisible"):
        TransformerSpec(1, 32, 5, 64)


# ---------------------------------------------------------------------------
# the single-device oracle and the sharded session
# ---------------------------------------------------------------------------

def test_reference_decode_matches_the_reference():
    _, wnp, ref_toks, ref_lg = oracle()
    toks, lg = reference_decode(SPEC, transformer_weights_from_numpy(
        wnp, "cpu"), PROMPT, N_NEW)
    assert toks == ref_toks
    assert tuple(lg.shape) == (N_NEW, SPEC.vocab)
    _close(lg, ref_lg)


@pytest.mark.parametrize("nodes", [1, 2, 4, 8])
def test_decode_session_matches_jax_session_and_oracle(nodes):
    """Searched plan at max(nodes, 2), as tests/test_decode.py does: the
    port's local DecodeSession under both backends gives the tokens of the
    JAX local DecodeSession (xla backend) and of the JAX oracle."""
    wj, wnp, ref_toks, ref_lg = oracle()
    pj, pt = _plans(max(nodes, 2))
    sj = JDecodeSession(J_SPEC, wj, pj, nodes, JExecConfig(),
                        page_size=4, capacity=32)
    toks_j, lg_j = j_greedy_decode(sj, PROMPT, N_NEW)
    assert toks_j == ref_toks
    wt = transformer_weights_from_numpy(wnp, "cpu")
    for backend in ("torch", "cuda"):
        st = DecodeSession(SPEC, wt, pt, nodes,
                           ExecConfig(backend=backend, **CPU),
                           page_size=4, capacity=32)
        toks, lg = greedy_decode(st, PROMPT, N_NEW)
        assert toks == toks_j == ref_toks, backend
        _close(lg, ref_lg)
        _close(lg, np.asarray(lg_j))
        assert st.cache.length == len(PROMPT) + N_NEW
        assert st.head_split == sj.head_split
        for n in range(nodes):
            assert st.cache.bytes_per_node(n) == sj.cache.bytes_per_node(n)
            k, v = st.cache.gather(1, n)
            kj, vj = sj.cache.gather(1, n)
            np.testing.assert_allclose(k.numpy(), np.asarray(kj),
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(v.numpy(), np.asarray(vj),
                                       rtol=1e-4, atol=1e-4)


def test_decode_mixed_plan_replicated_layers():
    """The reference's mixed plan: replicated ATTN in block 0 and
    replicated FFN in block 1 still match (the DP may mix)."""
    _, wnp, ref_toks, ref_lg = oracle()
    plan = Plan(((Scheme.INH, Mode.T), (Scheme.OUTC, Mode.T),
                 (Scheme.OUTC, Mode.T), (Scheme.INH, Mode.T)))
    wt = transformer_weights_from_numpy(wnp, "cpu")
    for backend in ("torch", "cuda"):
        sess = DecodeSession(SPEC, wt, plan, 4,
                             ExecConfig(backend=backend, **CPU),
                             page_size=4, capacity=32)
        toks, lg = greedy_decode(sess, PROMPT, N_NEW)
        assert toks == ref_toks
        _close(lg, ref_lg)
        assert sess.cache.bytes_per_node(0) == sess.cache.bytes_per_node(3)


def _property_case(seed):
    """tests/test_decode.py::_property_case: random geometry, page size,
    prompt, node count and mixed plan, the port against the JAX oracle."""
    rng = np.random.default_rng(seed)
    H = int(rng.choice([1, 2, 4, 6]))
    hd = int(rng.choice([4, 8]))
    kw = dict(n_layers=int(rng.integers(1, 3)), d_model=H * hd, n_heads=H,
              d_ff=int(rng.choice([16, 32])), vocab=32)
    spec, jspec = TransformerSpec(**kw), JSpec(**kw)
    page_size = int(rng.integers(1, 6))
    prompt = [int(t) for t in rng.integers(0, spec.vocab, rng.integers(1, 6))]
    n_new = int(rng.integers(1, 5))
    nodes = int(rng.integers(1, 5))
    total = len(prompt) + n_new
    ref_toks, ref_lg = j_reference_decode(
        jspec, j_init_transformer(jspec, seed=seed), prompt, n_new)
    steps = []
    for _ in range(spec.n_layers):
        steps.append((Scheme.OUTC if rng.random() < 0.75 else Scheme.INH,
                      Mode.T))
        steps.append((Scheme.OUTC if rng.random() < 0.5 else Scheme.INH,
                      Mode.T))
    sess = DecodeSession(spec, init_transformer(spec, seed=seed, **CPU),
                         Plan(tuple(steps)), nodes,
                         ExecConfig(**CPU), page_size=page_size,
                         capacity=total + int(rng.integers(0, 7)),
                         cache_seed=seed + 1)
    toks, lg = greedy_decode(sess, prompt, n_new)
    assert toks == ref_toks, (seed, spec)
    _close(lg, np.asarray(ref_lg))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 5, 8, 13, 21])
def test_property_paged_sharded_decode(seed):
    _property_case(seed)


# ---------------------------------------------------------------------------
# the paged cache
# ---------------------------------------------------------------------------

def test_paged_cache_bytes_and_gather_equal_the_reference():
    split = [[3, 1], [2, 2]]
    cj = JPagedKVCache(split, head_dim=4, page_size=3, capacity=14, seed=2)
    ct = PagedKVCache(split, head_dim=4, page_size=3, capacity=14, seed=2,
                      **CPU)
    rng = np.random.default_rng(0)
    for pos in range(8):
        for layer, per_node in enumerate(split):
            for node, lh in enumerate(per_node):
                k = rng.normal(size=(lh, 4)).astype(np.float32)
                cj.append(layer, node, pos, jnp.asarray(k),
                          jnp.asarray(2 * k))
                ct.append(layer, node, pos, torch.from_numpy(k),
                          torch.from_numpy(2 * k))
        assert ct.advance() == cj.advance()
    for layer in range(2):
        for node in range(2):
            assert ct.bytes_per_node(node) == cj.bytes_per_node(node)
            for a, b in zip(ct.gather(layer, node), cj.gather(layer, node)):
                assert tuple(a.shape) == b.shape
                assert np.array_equal(a.numpy(), np.asarray(b))
            for a, b in zip(ct.pages(layer, node), cj.pages(layer, node)):
                assert np.array_equal(a.numpy(), np.asarray(b))


def test_paged_cache_overflow_and_bounds():
    cache = PagedKVCache([[1]], head_dim=2, page_size=2, capacity=4, **CPU)
    cache.advance(4)
    with pytest.raises(ValueError, match="overflow"):
        cache.advance(1)
    with pytest.raises(ValueError, match="capacity"):
        cache.slot(4)
    with pytest.raises(ValueError, match="pool shape"):
        cache.store(0, 0, torch.zeros((2, 2, 2, 2)), torch.zeros((2, 2, 2,
                                                                    2)))
    with pytest.raises(ValueError, match="page geometry"):
        PagedKVCache([[1]], head_dim=2, page_size=0, capacity=4, **CPU)


def test_decode_session_device_and_executor_rules():
    _, wnp, _, _ = oracle()
    wt = transformer_weights_from_numpy(wnp, "cpu")
    plan = _plans(2)[1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DecodeSession(SPEC, wt, plan, 2)
    with pytest.raises(ValueError, match="executor"):
        ExecConfig(executor="remote", **CPU)
    with pytest.raises(ValueError, match="mesh must be 1-D"):
        DecodeSession(SPEC, wt, plan, 2, ExecConfig(executor="mesh", **CPU),
                      mesh=make_nodes_mesh(4, ["cpu"]))
    with pytest.raises(ValueError, match="steps"):
        DecodeSession(SPEC, wt, Plan(plan.steps[:2]), 2, ExecConfig(**CPU))
    meta = {"emb": wt["emb"].to("meta"), "blocks": wt["blocks"]}
    with pytest.raises(ValueError, match="weights lie on"):
        DecodeSession(SPEC, meta, plan, 2, ExecConfig(**CPU))
