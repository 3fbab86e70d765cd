"""The port's planner-level modules against the JAX package's.

``repro_torch.core`` and ``repro_torch.configs`` are trimmed copies of
``repro.core`` and ``repro.configs``; these tests hold them to the
reference: the same layer graphs, the same geometry helpers, and
``plan_search`` results with identical steps (compared by enum value) and
bit-identical costs.
"""
import dataclasses

import pytest

from repro.configs.edge_models import EDGE_MODELS as J_MODELS
from repro.core import AnalyticEstimator as JEstimator
from repro.core import Testbed as JTestbed
from repro.core.dpp import plan_search as j_plan_search
from repro.core.graph import (conv_geometries as j_conv_geometries,
                              halo_growth as j_halo_growth,
                              shard_halo_pads as j_shard_halo_pads)
from repro.core.partition import Scheme as JScheme
from repro.core.plan import (fixed_plan as j_fixed_plan,
                             plan_cost as j_plan_cost,
                             plan_feasible as j_plan_feasible)

from repro_torch.configs.edge_models import EDGE_MODELS as T_MODELS
from repro_torch.core import AnalyticEstimator, Scheme
from repro_torch.core import Testbed as TorchTestbed
from repro_torch.core.dpp import plan_search
from repro_torch.core.graph import (conv_geometries, halo_growth,
                                    shard_halo_pads)
from repro_torch.core.plan import fixed_plan, plan_cost, plan_feasible

#: the reference's test-scale constructor kwargs
#: (tests/test_kernel_conformance.py MODEL_TEST_KW)
MODEL_TEST_KW = {
    "mobilenet": dict(width=32),
    "resnet18": dict(width=32),
    "resnet101": dict(width=32),
    "inception": dict(width=32),
    "bert": dict(seq=16, d=32, n_layers=1, d_ff=64),
}
SCALES = ("full", "test")


def _graphs(name, scale):
    kw = {} if scale == "full" else MODEL_TEST_KW[name]
    return J_MODELS[name](**kw), T_MODELS[name](**kw)


def _layer_tuple(l):
    t = dataclasses.astuple(l)
    return (t[0], int(l.conv_t)) + t[2:]


def _steps(plan):
    return [(int(s), int(m)) for s, m in plan.steps]


def test_same_model_set():
    assert sorted(J_MODELS) == sorted(T_MODELS)


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("name", sorted(J_MODELS))
def test_graph_ir_matches(name, scale):
    gj, gt = _graphs(name, scale)
    assert gt.name == gj.name
    assert [_layer_tuple(l) for l in gt.layers] == \
        [_layer_tuple(l) for l in gj.layers]
    assert gt.producer_ids == gj.producer_ids
    assert gt.consumer_ids == gj.consumer_ids
    assert gt.is_chain == gj.is_chain
    assert [b.ids for b in gt.linearize()] == \
        [b.ids for b in gj.linearize()]
    assert [(int(t), k, s, p) for t, k, s, p in conv_geometries(gt)] == \
        [(int(t), k, s, p) for t, k, s, p in j_conv_geometries(gj)]
    assert gt.total_flops() == gj.total_flops()
    for br_t, br_j in zip(gt.linearize(), gj.linearize()):
        lt = [gt.layers[i] for i in br_t.ids]
        lj = [gj.layers[i] for i in br_j.ids]
        assert halo_growth(lt, len(lt) - 1) == \
            j_halo_growth(lj, len(lj) - 1)


@pytest.mark.parametrize("p", [0, 1, 2, 3])
def test_shard_halo_pads_match(p):
    assert shard_halo_pads(p) == j_shard_halo_pads(p)


@pytest.mark.parametrize("bw", [0.5, 5.0])
@pytest.mark.parametrize("nodes", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(J_MODELS))
def test_plan_search_bit_identical(name, nodes, bw):
    """Same steps by enum value and the same cost, bit for bit."""
    gj, gt = _graphs(name, "full")
    rj = j_plan_search(gj, JEstimator(), JTestbed(nodes=nodes,
                                                  bandwidth_gbps=bw))
    rt = plan_search(gt, AnalyticEstimator(),
                     TorchTestbed(nodes=nodes, bandwidth_gbps=bw))
    assert _steps(rt.plan) == _steps(rj.plan)
    assert rt.cost == rj.cost
    assert (rt.stats.i_calls, rt.stats.s_calls, rt.stats.pruned_halo) == \
        (rj.stats.i_calls, rj.stats.s_calls, rj.stats.pruned_halo)


@pytest.mark.parametrize("nodes", [2, 3, 5])
@pytest.mark.parametrize("name", sorted(J_MODELS))
def test_fixed_plans_cost_and_feasibility_match(name, nodes):
    gj, gt = _graphs(name, "test")
    for scheme in Scheme:
        pt = fixed_plan(gt, scheme)
        pj = j_fixed_plan(gj, JScheme(int(scheme)))
        assert _steps(pt) == _steps(pj)
        assert plan_feasible(gt, pt, nodes) == j_plan_feasible(gj, pj, nodes)
        assert plan_cost(gt, pt, AnalyticEstimator(),
                         TorchTestbed(nodes=nodes)) == \
            j_plan_cost(gj, pj, JEstimator(), JTestbed(nodes=nodes))


@pytest.mark.parametrize("name", ["mobilenet", "resnet18"])
def test_searched_plan_feasibility_matches(name):
    """A searched NT-fused plan is feasible on both sides at its node count
    and at a node count where its halos may degenerate."""
    gj, gt = _graphs(name, "test")
    res = plan_search(gt, AnalyticEstimator(), TorchTestbed(nodes=4))
    pj = j_plan_search(gj, JEstimator(), JTestbed(nodes=4)).plan
    for nodes in (2, 4, 8):
        assert plan_feasible(gt, res.plan, nodes) == \
            j_plan_feasible(gj, pj, nodes)


def test_plan_search_runs_a_scalar_only_estimator_as_the_reference():
    """An estimator with only ``i_cost``/``s_cost`` takes the scalar
    search, ``plan_search_reference``: the JAX package's plan, cost and
    call counts on the chain and the DAG models."""
    from repro.core.dpp import plan_search_reference as j_reference

    def scalar(base):
        class ScalarOnly:
            def i_cost(self, *a, **k):
                return base.i_cost(*a, **k)

            def s_cost(self, *a, **k):
                return base.s_cost(*a, **k)
        return ScalarOnly()

    for name in ("bert", "mobilenet", "inception"):
        gj, gt = _graphs(name, "test")
        res = plan_search(gt, scalar(AnalyticEstimator()),
                          TorchTestbed(nodes=2))
        ref = j_reference(gj, scalar(JEstimator()), JTestbed(nodes=2))
        assert _steps(res.plan) == _steps(ref.plan)
        assert res.cost == ref.cost
        assert vars(res.stats) == vars(ref.stats)
