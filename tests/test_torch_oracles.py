"""The port's oracles and scalar paths against the JAX package's: the
Theorem-1 oracle (``core.exhaustive``), the §4 baselines
(``core.baselines``), the scalar reference search
(``dpp.plan_search_reference``) and ``cost_tables.PrefetchedEstimator``.

The cases of ``tests/test_dpp.py``, the ``exhaustive_search`` cases of
``tests/test_dag.py`` and ``tests/test_cluster.py`` and the prefetch
cases of ``tests/test_cost_tables.py`` run against the port, each held
to the reference's result in the same process: plans equal by enum
value, costs and ``SearchStats`` equal to the bit.
"""
import random

import numpy as np
import pytest

import repro.cluster as jcl
from repro.core import AnalyticEstimator as JEstimator
from repro.core import Testbed as JTestbed
from repro.core import Topology as JTopology
from repro.core import baselines as jbaselines
from repro.core import graph as jgraph
from repro.core.dpp import plan_search as j_plan_search
from repro.core.dpp import plan_search_reference as j_plan_search_reference
from repro.core.exhaustive import exhaustive_search as j_exhaustive_search
from repro.core.exhaustive import enumerate_plans as j_enumerate_plans
from repro.core.partition import Scheme as JScheme

import repro_torch.cluster as tcl
from repro_torch.configs.edge_models import EDGE_MODELS
from repro_torch.core import (ALL_SCHEMES, AnalyticEstimator,
                              PrefetchedEstimator, Scheme, Topology,
                              baselines, build_chain_tables, plan_cost,
                              plan_search, plan_search_reference)
from repro_torch.core import Testbed as TorchTestbed
from repro_torch.core import graph as tgraph
from repro_torch.core.exhaustive import (enumerate_dag_plans,
                                         enumerate_plans, exhaustive_search)
from repro_torch.core.graph import halo_growth
from repro_torch.core.plan import plan_feasible
from torch_cluster_pairs import (clusters, graphs, steps, to_jplan, toy_chain,
                                 toy_dag)

EST, JEST = AnalyticEstimator(), JEstimator()


def _rand_graph(rng, n, g):
    """tests/test_dpp.py's random conv chain, built with graph module
    ``g`` (either package's) from ``rng``'s stream."""
    layers = []
    h = rng.choice([14, 28, 56])
    c = rng.choice([16, 32, 64])
    for i in range(n):
        t = rng.choice([g.ConvT.CONV, g.ConvT.POINTWISE, g.ConvT.DWCONV])
        k, s, p = {g.ConvT.CONV: (3, 1, 1), g.ConvT.POINTWISE: (1, 1, 0),
                   g.ConvT.DWCONV: (3, 1, 1)}[t]
        cout = c if t == g.ConvT.DWCONV else rng.choice([c, 2 * c,
                                                         max(16, c // 2)])
        layer = g.LayerSpec(f"l{i}", t, h, h, c, cout, k, s, p)
        layers.append(layer)
        h, c = layer.out_h, cout
    return g.chain("rand", layers)


def _pair(seed, n_lo, n_hi, tb_kw):
    """(reference graph, port graph, reference testbed, port testbed) from
    one seed: both sides draw the same stream."""
    out = []
    for g, Tb, Topo in ((jgraph, JTestbed, JTopology),
                        (tgraph, TorchTestbed, Topology)):
        rng = random.Random(seed)
        graph = _rand_graph(rng, rng.randint(n_lo, n_hi), g)
        out += [graph, Tb(**tb_kw(rng, Topo))]
    gj, tbj, gt, tbt = out
    return gj, gt, tbj, tbt


def _same_result(res, ref):
    assert steps(res.plan) == steps(ref.plan)
    assert res.cost == ref.cost
    assert vars(res.stats) == vars(ref.stats)


# ---------------------------------------------------------------------------
# tests/test_dpp.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_dpp_matches_exhaustive(seed):
    """Theorem 1: with a correct cost oracle DPP is optimal — and the
    oracle's optimum is the reference's plan and cost."""
    gj, gt, tbj, tbt = _pair(seed, 2, 6, lambda rng, Topo: dict(
        nodes=rng.choice([3, 4, 5]),
        bandwidth_gbps=rng.choice([0.5, 1.0, 5.0]),
        topology=Topo(rng.randint(0, 2))))
    best_plan, best = exhaustive_search(gt, EST, tbt)
    jplan, jbest = j_exhaustive_search(gj, JEST, tbj)
    assert steps(best_plan) == steps(jplan) and best == jbest
    res = plan_search(gt, EST, tbt)
    assert res.cost == pytest.approx(best, rel=1e-12)
    assert plan_cost(gt, res.plan, EST, tbt) == pytest.approx(res.cost,
                                                              rel=1e-9)


@pytest.mark.parametrize("seed", range(4))
def test_flexpie_dominates_baselines(seed):
    """FlexPie searches a superset space: it can never lose to a
    baseline; every column equals the reference's."""
    gj, gt, tbj, tbt = _pair(100 + seed, 4, 10, lambda rng, Topo: dict(
        nodes=4, bandwidth_gbps=rng.choice([0.5, 5.0])))
    sols = baselines.all_solutions(gt, EST, tbt)
    jsols = jbaselines.all_solutions(gj, JEST, tbj)
    assert list(sols) == list(jsols)
    for name, (plan, cost) in sols.items():
        assert steps(plan) == steps(jsols[name][0]), name
        assert cost == jsols[name][1], name
    flex = sols["flexpie"][1]
    for name, (_, cost) in sols.items():
        assert flex <= cost + 1e-12, (name, cost, flex)
    times = {k: v[1] for k, v in sols.items()}
    scores = baselines.performance_scores(times)
    assert scores == jbaselines.performance_scores(times)
    assert scores["flexpie"] == pytest.approx(1.0)


def test_pruning_reduces_calls():
    gj, gt, tbj, tbt = _pair(7, 10, 10, lambda rng, Topo: dict(nodes=4))
    res = plan_search(gt, EST, tbt)
    assert res.stats.i_calls + res.stats.s_calls < 20_000
    assert res.stats.pruned_threshold + res.stats.pruned_halo > 0
    _same_result(res, j_plan_search(gj, JEST, tbj))


@pytest.mark.parametrize("model", list(EDGE_MODELS))
def test_batched_search_bit_matches_reference(model):
    """The batched DP returns the exact plan and cost of the scalar
    reference on every benchmark model (chain and DAG), and both equal
    the JAX package's ``plan_search_reference``."""
    gj, gt = graphs(model)
    tbt, tbj = TorchTestbed(nodes=4, bandwidth_gbps=1.0), \
        JTestbed(nodes=4, bandwidth_gbps=1.0)
    res = plan_search(gt, EST, tbt)
    ref = plan_search_reference(gt, EST, tbt)
    assert steps(res.plan) == steps(ref.plan)
    assert res.cost == ref.cost
    assert res.stats.i_calls <= ref.stats.i_calls
    assert res.stats.s_calls <= ref.stats.s_calls
    _same_result(ref, j_plan_search_reference(gj, JEST, tbj))


@pytest.mark.parametrize("seed", range(6))
def test_batched_search_matches_reference_random(seed):
    """Parity under random graphs, node counts, topologies and the
    restricted search modes the baselines use."""
    gj, gt, tbj, tbt = _pair(1000 + seed, 2, 12, lambda rng, Topo: dict(
        nodes=rng.choice([1, 3, 4, 5]),
        bandwidth_gbps=rng.choice([0.5, 1.0, 5.0]),
        topology=Topo(rng.randint(0, 2))))
    for kw in ({}, {"allow_fusion": False}, {"schemes": (Scheme.INH,)},
               {"schemes": (Scheme.OUTC,)}, {"max_segment": 3}):
        res = plan_search(gt, EST, tbt, **kw)
        ref = plan_search_reference(gt, EST, tbt, **kw)
        assert steps(res.plan) == steps(ref.plan), kw
        assert res.cost == ref.cost, kw
        jkw = dict(kw)
        if "schemes" in kw:
            jkw["schemes"] = tuple(JScheme(int(s)) for s in kw["schemes"])
        _same_result(ref, j_plan_search_reference(gj, JEST, tbj, **jkw))


def test_batched_stats_stay_meaningful():
    gj, gt, tbj, tbt = _pair(7, 10, 10, lambda rng, Topo: dict(nodes=4))
    st = plan_search(gt, EST, tbt).stats
    assert st.states == len(gt) * len(ALL_SCHEMES)
    assert 0 < st.i_calls and 0 < st.s_calls
    assert st.pruned_halo > 0
    ref = plan_search_reference(gt, EST, tbt).stats
    assert st.i_calls <= ref.i_calls and st.s_calls <= ref.s_calls
    assert vars(ref) == vars(j_plan_search_reference(gj, JEST, tbj).stats)


def test_layerwise_beats_fixed_on_heterogeneous_graph():
    """Layers with different shapes prefer different schemes (Fig. 2)."""
    out = []
    for g, Tb in ((jgraph, JTestbed), (tgraph, TorchTestbed)):
        L, C = g.LayerSpec, g.ConvT
        out.append((g.chain("hetero", [
            L("big_spatial", C.CONV, 56, 56, 16, 16, 3, 1, 1),
            L("deep_channel", C.POINTWISE, 56, 56, 16, 512, 1, 1, 0),
            L("deep_channel2", C.POINTWISE, 56, 56, 512, 512, 1, 1, 0),
        ]), Tb(nodes=4, bandwidth_gbps=5.0)))
    (gj, tbj), (gt, tbt) = out
    sols = baselines.all_solutions(gt, EST, tbt)
    assert sols["layerwise"][1] <= min(sols["one_dim_inh"][1],
                                       sols["one_dim_outc"][1]) + 1e-12
    jsols = jbaselines.all_solutions(gj, JEST, tbj)
    assert {k: v[1] for k, v in sols.items()} == \
        {k: v[1] for k, v in jsols.items()}


def test_scalar_only_estimator_searches_like_the_reference():
    """An estimator with only the scalar protocol (one keyed on layer
    names, which the tables cannot dedupe) runs the scalar providers on
    every objective, as in the reference."""
    from repro.core.dpp import Objective as JObjective
    from repro.core.dpp import pipeline_frontier as j_pipeline_frontier
    from repro_torch.core import Objective, pipeline_frontier

    def named(base):
        class ByName:
            def i_cost(self, layer, scheme, tb, extra_halo=0):
                return base.i_cost(layer, scheme, tb, extra_halo) * \
                    (1.0 + 0.01 * len(layer.name))

            def s_cost(self, layer, nxt, src, dst, tb):
                return base.s_cost(layer, nxt, src, dst, tb)
        return ByName()

    for name in ("mobilenet", "inception"):
        gj, gt = graphs(name, "test")
        tbt, tbj = TorchTestbed(nodes=4), JTestbed(nodes=4)
        _same_result(plan_search(gt, named(EST), tbt),
                     j_plan_search(gj, named(JEST), tbj))
        fr = pipeline_frontier(gt, named(EST), tbt, prune_ub=False)
        jfr = j_pipeline_frontier(gj, named(JEST), tbj, prune_ub=False)
        assert np.array_equal(fr.points, jfr.points)
        assert [steps(fr.plan(i)) for i in range(len(fr))] == \
            [steps(jfr.plan(i)) for i in range(len(jfr))]
        res = plan_search(gt, named(EST), tbt,
                          objective=Objective.THROUGHPUT)
        jres = j_plan_search(gj, named(JEST), tbj,
                             objective=JObjective.THROUGHPUT)
        assert steps(res.plan) == steps(jres.plan) and res.cost == jres.cost


# ---------------------------------------------------------------------------
# tests/test_dag.py's and tests/test_cluster.py's exhaustive cases
# ---------------------------------------------------------------------------

def _inception_dag(g, h=16):
    """tests/test_dag.py's stem -> {1x1, 1x1->3x3, pool} -> CONCAT -> head."""
    L, C = g.LayerSpec, g.ConvT
    return g.ModelGraph(name="inc", layers=(
        L("stem", C.CONV, h, h, 3, 8, 3, 1, 1),
        L("b1", C.POINTWISE, h, h, 8, 4, 1, 1, 0, inputs=("stem",)),
        L("b2a", C.POINTWISE, h, h, 8, 4, 1, 1, 0, inputs=("stem",)),
        L("b2b", C.CONV, h, h, 4, 8, 3, 1, 1, inputs=("b2a",)),
        L("b3", C.POOL, h, h, 8, 8, 3, 1, 1, inputs=("stem",)),
        L("cat", C.CONCAT, h, h, 20, 20, inputs=("b1", "b2b", "b3")),
        L("head", C.CONV, h, h, 20, 8, 3, 1, 1),
    ))


DAGS = {"resnet_block": toy_dag,
        "inception": lambda: (_inception_dag(jgraph), _inception_dag(tgraph))}


@pytest.mark.parametrize("model", sorted(DAGS))
@pytest.mark.parametrize("seed", range(4))
def test_dag_dpp_matches_exhaustive(model, seed):
    rng = random.Random(seed)
    gj, gt = DAGS[model]()
    kw = dict(nodes=rng.choice([3, 4, 5]),
              bandwidth_gbps=rng.choice([0.5, 1.0, 5.0]))
    topo = rng.randint(0, 2)
    tbt = TorchTestbed(topology=Topology(topo), **kw)
    tbj = JTestbed(topology=JTopology(topo), **kw)
    plan, best = exhaustive_search(gt, EST, tbt)
    jplan, jbest = j_exhaustive_search(gj, JEST, tbj)
    assert steps(plan) == steps(jplan) and best == jbest
    res = plan_search(gt, EST, tbt)
    assert res.cost == pytest.approx(best, rel=1e-12)
    assert plan_cost(gt, res.plan, EST, tbt) == pytest.approx(res.cost,
                                                              rel=1e-9)
    assert plan_feasible(gt, res.plan, tbt.nodes)


@pytest.mark.parametrize("model", sorted(DAGS))
@pytest.mark.parametrize("nodes", [3, 4, 5])
def test_dag_batched_search_bit_matches_reference(model, nodes):
    gj, gt = DAGS[model]()
    tbt = TorchTestbed(nodes=nodes, bandwidth_gbps=1.0)
    res = plan_search(gt, EST, tbt)
    ref = plan_search_reference(gt, EST, tbt)
    assert steps(res.plan) == steps(ref.plan) and res.cost == ref.cost
    _same_result(ref, j_plan_search_reference(
        gj, JEST, JTestbed(nodes=nodes, bandwidth_gbps=1.0)))


def test_dag_plan_enumeration_matches_the_reference():
    from repro.core.exhaustive import enumerate_dag_plans as j_enum_dag
    for model in sorted(DAGS):
        gj, gt = DAGS[model]()
        assert [steps(p) for p in enumerate_dag_plans(gt)] == \
            [steps(p) for p in j_enum_dag(gj)]
    for n in (1, 2, 4):
        for fusion in (True, False):
            assert [steps(p) for p in enumerate_plans(n, allow_fusion=fusion)
                    ] == [steps(p) for p in
                          j_enumerate_plans(n, allow_fusion=fusion)]


@pytest.mark.parametrize("preset", ["mixed_fast_slow", "stepped",
                                    "asym_uplink"])
@pytest.mark.parametrize("nodes", [2, 3, 4, 6])
def test_hetero_dp_matches_exhaustive_chain(preset, nodes):
    gj, gt = toy_chain()
    jc, tc = clusters(preset, nodes)
    est = tcl.ClusterAnalyticEstimator(tc)
    tb = tc.compat_testbed()
    res = tcl.cluster_plan_search(gt, tc)
    ref = plan_search_reference(gt, est, tb)
    assert steps(res.plan) == steps(ref.plan) and res.cost == ref.cost
    plan, ex_cost = exhaustive_search(gt, est, tb)
    assert abs(res.cost - ex_cost) < 1e-15
    jplan, jex = j_exhaustive_search(gj, jcl.ClusterAnalyticEstimator(jc),
                                     jc.compat_testbed())
    assert steps(plan) == steps(jplan) and ex_cost == jex


@pytest.mark.parametrize("preset", ["mixed_fast_slow", "stepped",
                                    "asym_uplink"])
def test_hetero_dp_matches_exhaustive_dag(preset):
    gj, gt = toy_dag()
    jc, tc = clusters(preset, 4)
    est = tcl.ClusterAnalyticEstimator(tc)
    tb = tc.compat_testbed()
    res = tcl.cluster_plan_search(gt, tc)
    ref = plan_search_reference(gt, est, tb)
    assert steps(res.plan) == steps(ref.plan) and res.cost == ref.cost
    plan, ex_cost = exhaustive_search(gt, est, tb)
    assert abs(res.cost - ex_cost) / ex_cost < 1e-12
    jplan, jex = j_exhaustive_search(gj, jcl.ClusterAnalyticEstimator(jc),
                                     jc.compat_testbed())
    assert steps(plan) == steps(jplan) and ex_cost == jex


@pytest.mark.parametrize("objective", ["THROUGHPUT", "P99_BOUNDED"])
def test_exhaustive_throughput_objectives_match_the_reference(objective):
    from repro.core.dpp import Objective as JObjective
    from repro_torch.core import Objective
    for gj, gt in (toy_chain(), toy_dag()):
        jc, tc = clusters("asym_uplink", 4)
        est = tcl.ClusterAnalyticEstimator(tc)
        tb = tc.compat_testbed()
        bound = 2.0 * tcl.cluster_plan_search(gt, tc).cost
        plan, cost = exhaustive_search(gt, est, tb,
                                       objective=Objective[objective],
                                       latency_bound_s=bound)
        jplan, jcost = j_exhaustive_search(
            gj, jcl.ClusterAnalyticEstimator(jc), jc.compat_testbed(),
            objective=JObjective[objective], latency_bound_s=bound)
        assert steps(plan) == steps(jplan) and cost == jcost
        res = tcl.cluster_plan_search(gt, tc, objective=Objective[objective],
                                      latency_bound_s=bound)
        assert res.cost == pytest.approx(cost, rel=1e-12)


# ---------------------------------------------------------------------------
# tests/test_cost_tables.py's prefetch and scalar-table cases
# ---------------------------------------------------------------------------

def _rand_chain(rng, n, g):
    layers = []
    h, c = rng.choice([14, 28, 56]), rng.choice([16, 32])
    for i in range(n):
        t = rng.choice([g.ConvT.CONV, g.ConvT.POINTWISE, g.ConvT.DWCONV])
        k, s, p = {g.ConvT.CONV: (3, 1, 1), g.ConvT.POINTWISE: (1, 1, 0),
                   g.ConvT.DWCONV: (3, 1, 1)}[t]
        cout = c if t == g.ConvT.DWCONV else rng.choice([c, 2 * c])
        layers.append(g.LayerSpec(f"l{i}", t, h, h, c, cout, k, s, p))
        h, c = layers[-1].out_h, cout
    return g.chain("rand", layers)


@pytest.mark.parametrize("seed", range(4))
def test_chain_tables_hold_scalar_values(seed):
    """Every finite ``seg`` entry equals the scalar i-cost sum; every
    boundary entry equals the scalar s-cost; the tables equal the
    reference's."""
    from repro.core.cost_tables import build_chain_tables as j_build
    rng = random.Random(seed)
    g = _rand_chain(rng, rng.randint(3, 8), tgraph)
    tb = TorchTestbed(nodes=rng.choice([3, 4, 5]))
    tbl, ni, ns = build_chain_tables(g.layers, EST, tb, ALL_SCHEMES,
                                     max_segment=32, allow_fusion=True)
    n = len(g.layers)
    for i in range(n):
        for pi, p in enumerate(ALL_SCHEMES):
            for L in range(tbl.seg.shape[2]):
                v = tbl.seg[i, pi, L]
                if v == float("inf"):
                    continue
                halos = halo_growth(g.layers[i:i + L + 1], L)
                want = 0.0
                for off, m in enumerate(range(i, i + L + 1)):
                    want += EST.i_cost(g.layers[m], p, tb,
                                       extra_halo=halos[off] if L else 0)
                assert v == want
    for b in range(n - 1):
        for pi, p in enumerate(ALL_SCHEMES):
            for qi, q in enumerate(ALL_SCHEMES):
                assert tbl.sbound[b, pi, qi] == \
                    EST.s_cost(g.layers[b], g.layers[b + 1], p, q, tb)
    for pi, p in enumerate(ALL_SCHEMES):
        assert tbl.s_final[pi] == EST.s_cost(g.layers[-1], None, p, None, tb)
    rng = random.Random(seed)
    gj = _rand_chain(rng, rng.randint(3, 8), jgraph)
    from repro.core.partition import ALL_SCHEMES as J_ALL
    jtbl, jni, jns = j_build(gj.layers, JEST, JTestbed(nodes=tb.nodes),
                             J_ALL, max_segment=32, allow_fusion=True)
    assert (ni, ns) == (jni, jns)
    for f in ("seg", "sbound", "s_final"):
        assert np.array_equal(getattr(tbl, f), getattr(jtbl, f))


def test_prefetched_estimator_scores_plans_exactly():
    from repro.core.cost_tables import PrefetchedEstimator as JPrefetched
    from repro.core.plan import plan_cost as j_plan_cost
    rng = random.Random(7)
    g = _rand_chain(rng, 4, tgraph)
    gj = _rand_chain(random.Random(7), 4, jgraph)
    tb = TorchTestbed(nodes=4, bandwidth_gbps=1.0)
    tbj = JTestbed(nodes=4, bandwidth_gbps=1.0)
    pf = PrefetchedEstimator.for_graph(g, EST, tb)
    jpf = JPrefetched.for_graph(gj, JEST, tbj)
    checked = 0
    for plan in enumerate_plans(len(g)):
        if not plan_feasible(g, plan, tb.nodes):
            continue
        c = plan_cost(g, plan, pf, tb)
        assert c == plan_cost(g, plan, EST, tb)
        assert c == j_plan_cost(gj, to_jplan(plan), jpf, tbj)
        checked += 1
    assert checked > 50
    assert pf.cache_info() == jpf.cache_info()
    assert pf.cache_info()[1] == 0       # every query was prefetched


def test_prefetch_passes_a_scalar_only_estimator_through():
    class ScalarOnly:
        def i_cost(self, *a, **k):
            return 1.0

        def s_cost(self, *a, **k):
            return 1.0

    g = _rand_chain(random.Random(1), 3, tgraph)
    est = ScalarOnly()
    assert PrefetchedEstimator.for_graph(g, est, TorchTestbed()) is est
