"""The port's segment programs (``ExecConfig.jit_segments``) against the
JAX package's compiled-segment cache.

On CPU tensors a segment program runs its records eagerly, so these tests
reach the cache itself: its key, its hit and miss counts, and the
reassembly of cells that share a program.  Both packages get the same
numpy weights and input.  The captured CUDA graphs behind the programs on
the card are held against the eager path in ``test_torch_gpu.py``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.edge_models import resnet18 as j_resnet18
from repro.core import chain as j_chain
from repro.core.graph import ConvT as JConvT
from repro.core.graph import LayerSpec as JLayerSpec
from repro.core.partition import Scheme as JScheme
from repro.core.plan import fixed_plan as j_fixed_plan
from repro.runtime.engine import init_weights as j_init_weights
from repro.runtime.engine import run_reference as j_run_reference
from repro.runtime.session import ExecConfig as JExecConfig
from repro.runtime.session import Session as JSession

from repro_torch import (ExecConfig, Mode, Plan, Scheme, Session,
                         fixed_plan, weights_from_numpy)
from repro_torch.configs.edge_models import resnet18
from repro_torch.core.graph import ConvT, LayerSpec, chain
from repro_torch.runtime import engine
from repro_torch.runtime.engine import (clear_segment_cache,
                                        segment_cache_info)

from torch_conformance import check_segment_programs, rel_err


def _rn_rep():
    """tests/test_engine.py::test_jit_segment_cache_reuses_repeated_blocks'
    chain on both packages: the first two layers of resnet18 at width 32
    and two geometrically identical extra blocks under different names;
    the JAX ``init_weights`` (PRNGKey(2)) and input, as numpy."""
    def build(resnet, chain_fn, spec, conv):
        g = chain_fn("rn_prefix", resnet(width=32).layers[:2],
                     drop_edges=True)
        layers = list(g.layers)
        for tag in ("x", "y"):
            layers.append(spec(f"{tag}a", conv, 8, 8, 64, 64, 3, 1, 1))
        return chain_fn("rn_rep", layers)

    gj = build(j_resnet18, j_chain, JLayerSpec, JConvT.CONV)
    gt = build(resnet18, chain, LayerSpec, ConvT.CONV)
    key = jax.random.PRNGKey(2)
    wj = j_init_weights(gj, key)
    x = np.array(jax.random.normal(key, (32, 32, 3)))
    wnp = [None if w is None else np.asarray(w) for w in wj]
    return gj, wj, gt, weights_from_numpy(gt, wnp, "cpu"), x


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_jit_segment_cache_reuses_repeated_blocks(backend):
    """The reference test on the port's cache: the interior cells of the
    InH split share a program (hits on the first run), the second run
    makes no new program, the output is within 1e-5 of the JAX
    ``run_reference`` and within 1e-6 of ``jit_segments=False``.  The two
    identical blocks xa/ya do not share: their weights differ, and a
    program is keyed by its weights' pointers."""
    gj, wj, gt, wt, x = _rn_rep()
    ref = np.asarray(j_run_reference(gj, wj, x))
    xt = torch.from_numpy(x)
    plan = fixed_plan(gt, Scheme.INH)
    clear_segment_cache()
    sess = Session(gt, wt, plan, 4, ExecConfig(backend=backend,
                                               device="cpu"))
    out, _ = sess.run(xt)
    info1 = segment_cache_info()
    assert info1.hits > 0
    assert info1.currsize == info1.misses
    out2, _ = sess.run(xt)
    info2 = segment_cache_info()
    assert info2.misses == info1.misses
    assert info2.hits == info1.hits + info1.hits + info1.misses
    assert rel_err(out, ref) < 1e-5
    eager, _ = Session(gt, wt, plan, 4,
                       ExecConfig(backend=backend, jit_segments=False,
                                  device="cpu")).run(xt)
    assert float((out2 - eager).abs().max()) < 1e-6
    # the reference's own cache on the same chain: xa/ya share there, so
    # it makes fewer programs than the port
    jp = j_fixed_plan(gj, JScheme.INH)
    out_j, _ = JSession(gj, wj, jp, 4).run(x)
    assert rel_err(out, out_j) < 1e-5


def test_jit_segments_defaults_to_true_like_the_reference():
    assert ExecConfig().jit_segments is True
    assert JExecConfig().jit_segments is True
    assert ExecConfig(jit_segments=False, device="cpu").jit_segments is False


def test_clear_segment_cache_empties_the_cache():
    _, _, gt, wt, x = _rn_rep()
    sess = Session(gt, wt, fixed_plan(gt, Scheme.INH), 4,
                   ExecConfig(device="cpu"))
    sess.run(torch.from_numpy(x))
    assert segment_cache_info().currsize > 0
    clear_segment_cache()
    assert tuple(segment_cache_info()) == (0, 0, None, 0)
    sess.run(torch.from_numpy(x))
    info = segment_cache_info()
    assert info.misses == info.currsize > 0


def test_programs_are_keyed_by_their_weights():
    """Another Session on the same weights hits every program; one on
    other weights of the same shapes makes programs of its own for every
    cell that has a weight (the max-pool cells share theirs)."""
    _, _, gt, wt, x = _rn_rep()
    xt = torch.from_numpy(x)
    plan = fixed_plan(gt, Scheme.INH)
    clear_segment_cache()
    Session(gt, wt, plan, 4, ExecConfig(device="cpu")).run(xt)
    first = segment_cache_info()
    Session(gt, wt, plan, 4, ExecConfig(device="cpu")).run(xt)
    again = segment_cache_info()
    assert again.misses == first.misses
    assert again.hits == first.hits * 2 + first.misses
    weighted = sum(1 for key in engine._SEGMENTS
                   if any(w is not None for w in key[2]))
    assert 0 < weighted < first.currsize
    other = [None if w is None else w.clone() for w in wt]
    Session(gt, other, plan, 4, ExecConfig(device="cpu")).run(xt)
    assert segment_cache_info().currsize == first.currsize + weighted


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("name", ["bert", "mobilenet"])
def test_segment_programs_equal_the_eager_records(name, backend):
    """The chain models (the DAG models in test_torch_segments_dag.py, so
    the two files run on separate workers)."""
    check_segment_programs(name, backend)


def test_cells_sharing_a_program_keep_their_own_shards():
    """A chain whose InH cells all share one program (every cell the same
    records: a 1x1 conv over rows that divide evenly): each cell's shard
    lands in its own rows, and the whole equals the unsplit conv."""
    layer = LayerSpec("pw", ConvT.POINTWISE, 8, 4, 3, 5, 1, 1, 0)
    g = chain("pw", [layer])
    rng = np.random.default_rng(3)
    w = rng.standard_normal((1, 1, 3, 5)).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((8, 4, 3)).astype(np.float32))
    wt = weights_from_numpy(g, [w], "cpu")
    clear_segment_cache()
    out, _ = Session(g, wt, Plan(((Scheme.INH, Mode.T),)), 4,
                     ExecConfig(device="cpu")).run(x)
    assert segment_cache_info().currsize == 1
    assert segment_cache_info().hits == 3
    want = (x.reshape(-1, 3) @ wt[0].reshape(3, 5)).reshape(8, 4, 5)
    assert rel_err(out, want) < 1e-6
