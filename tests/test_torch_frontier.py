"""The port's throughput planner — the (compute, sync) Pareto-frontier DP
(``core.dpp.pipeline_frontier``, ``PlanFrontier``, ``FrontierTables``) and
``plan_search`` under the THROUGHPUT and P99_BOUNDED objectives — against
the JAX package's, on the chain models and the Inception DAG.

Every edge model at full size on the frontier grid's five clusters, with
``prune_ub`` True and False: the frontier's points bit-equal
(``np.array_equal``), the plan at every index equal by enum value,
``select`` equal under re-weighted axes, and the throughput searches equal
in plan, cost and ``PipelineCost``.  The residual DAGs are in
``test_torch_frontier_dag.py``.
"""
import numpy as np
import pytest

import repro.cluster as jcl
from repro.core.dpp import FrontierTables as JFrontierTables

import repro_torch.cluster as tcl
from repro_torch.core import AnalyticEstimator, Objective, plan_search
from repro_torch.core import Testbed as TorchTestbed
from repro_torch.core.dpp import FrontierTables, pipeline_frontier
from repro_torch.core.plan import plan_cost, plan_pipeline_cost
from torch_cluster_pairs import (CLUSTERS, check_frontier, check_searches,
                                 cluster_id, clusters, graphs, steps)

MODELS = ("mobilenet", "bert", "inception")

@pytest.mark.parametrize("prune_ub", [True, False], ids=["pruned", "full"])
@pytest.mark.parametrize("cluster", CLUSTERS, ids=cluster_id)
@pytest.mark.parametrize("name", MODELS)
def test_frontier_matches(name, cluster, prune_ub):
    check_frontier(name, cluster, prune_ub)


@pytest.mark.parametrize("cluster", CLUSTERS, ids=cluster_id)
@pytest.mark.parametrize("name", MODELS)
def test_throughput_searches_match(name, cluster):
    check_searches(name, cluster)


def test_latency_selection_ties_the_latency_search():
    """On phase 3's testbed the frontier's latency point costs what
    ``plan_search``'s plan costs, up to float association.  Its plan may
    be another of equal cost: MobileNet and bert-base move an NT fusion
    boundary between identical blocks (the reference picks the same)."""
    est = AnalyticEstimator()
    for name in ("mobilenet", "resnet18", "bert"):
        g = graphs(name)[1]
        cl = tcl.homogeneous(4, bandwidth_gbps=0.5)
        tb = TorchTestbed(nodes=4, bandwidth_gbps=0.5)
        assert cl.compat_testbed() == tb
        fr = tcl.cluster_pipeline_frontier(g, cl, prune_ub=False)
        i = fr.select(Objective.LATENCY)
        res = plan_search(g, est, tb)
        pc = plan_pipeline_cost(g, res.plan, est, tb)
        assert abs(float(fr.points[i].sum()) - res.cost) <= 1e-12 * res.cost
        assert abs(plan_cost(g, fr.plan(i), est, tb) - res.cost) <= \
            1e-12 * res.cost
        for got, want in zip(fr.points[i], (pc.compute_s, pc.sync_s)):
            assert abs(got - want) <= 1e-12 * want


def test_frontier_tables_split_matches():
    """register / evaluate / frontier: a warm rebuild on one instance, and
    one from cached rows, bit-equal to a scratch build and to the
    reference's split; mismatched cached rows are refused."""
    for name in ("mobilenet", "inception"):
        gj, gt = graphs(name)
        jc, tc = clusters("stepped", 4)
        te = tcl.ClusterAnalyticEstimator(tc)
        je = jcl.ClusterAnalyticEstimator(jc)
        ft = FrontierTables.register(gt, te, tc.compat_testbed())
        fj = JFrontierTables.register(gj, je, jc.compat_testbed())
        iv, sv = ft.evaluate()
        jiv, jsv = fj.evaluate()
        assert np.array_equal(iv, jiv) and np.array_equal(sv, jsv)
        a = ft.frontier(iv, sv)
        aj = fj.frontier(jiv, jsv)
        b = ft.frontier(*ft.evaluate(ivals=iv))      # warm, cached i-rows
        bj = fj.frontier(*fj.evaluate(ivals=jiv))
        assert ft.last_reuse == fj.last_reuse
        for f in (aj, b, bj):
            assert np.array_equal(a.points, f.points)
        assert [steps(b.plan(i)) for i in range(len(b))] == \
            [steps(a.plan(i)) for i in range(len(a))]
        with pytest.raises(ValueError):
            ft.evaluate(ivals=iv[:-1])
        with pytest.raises(ValueError):
            ft.evaluate(svals=sv[:-1])


def test_frontier_of_a_scalar_only_estimator_matches_the_reference():
    """An estimator with only ``i_cost``/``s_cost`` takes the scalar
    providers: its frontier (pruned and full) and its throughput search
    are the JAX package's scalar frontier and search, and equal the
    batched estimator's; P99_BOUNDED still needs its bound."""
    from repro.core import AnalyticEstimator as JEstimator
    from repro.core import Testbed as JTestbed
    from repro.core.dpp import Objective as JObjective
    from repro.core.dpp import pipeline_frontier as j_pipeline_frontier
    from repro.core.dpp import plan_search as j_plan_search

    def scalar(base):
        class Scalar:
            def i_cost(self, *a, **k):
                return base.i_cost(*a, **k)

            def s_cost(self, *a, **k):
                return base.s_cost(*a, **k)
        return Scalar()

    for name in ("mobilenet", "inception"):
        gj, g = graphs(name, "test")
        tb, jtb = TorchTestbed(nodes=2), JTestbed(nodes=2)
        for kw in (dict(prune_ub=True), dict(prune_ub=False)):
            fr = pipeline_frontier(g, scalar(AnalyticEstimator()), tb, **kw)
            jfr = j_pipeline_frontier(gj, scalar(JEstimator()), jtb, **kw)
            batched = pipeline_frontier(g, AnalyticEstimator(), tb, **kw)
            assert np.array_equal(fr.points, jfr.points)
            assert np.allclose(fr.points, batched.points, rtol=1e-12,
                               atol=0)
            assert [steps(fr.plan(i)) for i in range(len(fr))] == \
                [steps(jfr.plan(i)) for i in range(len(jfr))]
        res = plan_search(g, scalar(AnalyticEstimator()), tb,
                          objective=Objective.THROUGHPUT)
        jres = j_plan_search(gj, scalar(JEstimator()), jtb,
                             objective=JObjective.THROUGHPUT)
        assert steps(res.plan) == steps(jres.plan) and res.cost == jres.cost
    g = graphs("mobilenet", "test")[1]
    tb = TorchTestbed(nodes=2)
    with pytest.raises(ValueError, match="latency_bound_s"):
        plan_search(g, AnalyticEstimator(), tb,
                    objective=Objective.P99_BOUNDED)
