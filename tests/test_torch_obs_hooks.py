"""The hooks that feed ``repro_torch.obs``, against the JAX package's, for
the same inputs in one process:

* the planner's spans (``plan_search`` table build, DP sweep and
  reconstruction on chains; the frontier's register / evaluate / DP),
  names, counts, nesting and arguments;
* ``CostTableBuilder``'s dedup counters and ``PrefetchedEstimator``'s
  ``push_metrics``;
* the refinement loop's ``refine.*`` gauges, histogram and counter, its
  flight records and its oscillation postmortem, on the occupancy
  functions of ``tests/test_elastic.py``;
* ``simsched.simulate_trace``'s Perfetto JSON, bit-equal;
* ``GBDTRegressor.fit(verbose_every=...)`` and
  ``train_estimators(verbose=True)`` log lines under ``REPRO_LOG``.
"""
import json

import numpy as np
import pytest
import torch

import repro.cluster as jcl
import repro.obs as jobs
import repro_torch.cluster as tcl
import repro_torch.obs as tobs
from repro.core import AnalyticEstimator as JEstimator
from repro.core import Testbed as JTestbed
from repro.core.cost_tables import PrefetchedEstimator as JPrefetched
from repro.core.dpp import FrontierTables as JFrontierTables
from repro.core.dpp import plan_search as j_plan_search
from repro.core.exhaustive import exhaustive_search as j_exhaustive
from repro.gbdt import GBDTRegressor as JGBDT
from repro.sim import trace as jtrace
from repro_torch.core import AnalyticEstimator
from repro_torch.core import Testbed as TorchTestbed
from repro_torch.core.cost_tables import PrefetchedEstimator
from repro_torch.core.dpp import FrontierTables, plan_search
from repro_torch.core.exhaustive import exhaustive_search
from repro_torch.gbdt import GBDTRegressor
from repro_torch.sim import trace as ttrace
from torch_cluster_pairs import (clusters, graphs, plain, steps, to_jplan,
                                 toy_chain, toy_dag)

SIDES = {"ref": jobs, "port": tobs}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The GBDT fits here are many small tensor ops: one intra-op thread
    (as ``tests/test_torch_gbdt.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_obs_globals():
    def clean():
        for obs in SIDES.values():
            obs.set_tracer(None)
            obs.set_metrics(None)
            obs.set_postmortem_dir(None)
            obs.get_flight().clear()
    clean()
    yield
    clean()


def observed(side, fn):
    """``fn()`` under a fresh tracer and metrics registry of one package:
    its result, the spans (name, category, track, depth, arguments) in
    start order, the instants, the metrics snapshot and the flight ring
    without its times."""
    obs = SIDES[side]
    tr = obs.set_tracer(obs.Tracer())
    mx = obs.set_metrics(obs.Metrics())
    obs.get_flight().clear()
    try:
        res = fn()
    finally:
        obs.set_tracer(None)
        obs.set_metrics(None)
    ring = [{k: v for k, v in e.items() if k != "t_us"}
            for e in obs.get_flight().events()]
    obs.get_flight().clear()
    return dict(
        result=res,
        spans=[(s["name"], s["cat"], s["track"], s["depth"], s["args"])
               for s in tr.spans()],
        instants=[(r["name"], r["args"]) for r in tr._records
                  if r["ph"] == "i"],
        metrics=mx.snapshot(), ring=ring)


def both(fn_ref, fn_port):
    ref, port = observed("ref", fn_ref), observed("port", fn_port)
    for key in ("spans", "instants", "metrics", "ring"):
        assert port[key] == ref[key], key
    return ref, port


GRAPHS = {"toy": toy_chain, "rb": toy_dag,
          "mobilenet": lambda: graphs("mobilenet", "small"),
          "resnet18": lambda: graphs("resnet18", "small"),
          "bert": lambda: graphs("bert", "small")}


# ---------------------------------------------------------------------------
# the planner's spans and the cost tables' counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("nodes", [3, 4])
def test_plan_search_spans_and_dedup_counters_equal(gname, nodes):
    gj, gt = GRAPHS[gname]()
    tbj, tbt = (JTestbed(nodes=nodes, bandwidth_gbps=0.5),
                TorchTestbed(nodes=nodes, bandwidth_gbps=0.5))
    ref, port = both(lambda: j_plan_search(gj, JEstimator(), tbj),
                     lambda: plan_search(gt, AnalyticEstimator(), tbt))
    assert steps(port["result"].plan) == steps(ref["result"].plan)
    names = [s[0] for s in ref["spans"]]
    if gj.is_chain:
        assert names == ["plan_search.table_build", "plan_search.dp_sweep",
                         "plan_search.reconstruct"]
    counters = ref["metrics"]["counters"]
    assert counters['cost_tables.dedup_misses{table="i"}'] > 0
    assert counters['cost_tables.dedup_misses{table="s"}'] > 0
    assert counters['cost_tables.dedup_hits{table="i"}'] > 0


@pytest.mark.parametrize("gname", ["toy", "rb", "mobilenet", "resnet18"])
def test_frontier_spans_equal(gname):
    gj, gt = GRAPHS[gname]()
    cj, ct = clusters("mixed_fast_slow", 4)
    ref, port = both(
        lambda: jcl.cluster_pipeline_frontier(gj, cj, prune_ub=False),
        lambda: tcl.cluster_pipeline_frontier(gt, ct, prune_ub=False))
    assert np.array_equal(port["result"].points, ref["result"].points)
    names = [s[0] for s in ref["spans"]]
    assert names == ["frontier.register", "frontier.evaluate",
                     "frontier.dp"]
    assert ref["spans"][-1][4]["points"] == len(ref["result"].points)
    # a warm rebuild on one FrontierTables instance reports its reuse
    fts = (JFrontierTables.register(gj, jcl.ClusterAnalyticEstimator(cj),
                                    cj.compat_testbed()),
           FrontierTables.register(gt, tcl.ClusterAnalyticEstimator(ct),
                                   ct.compat_testbed()))

    def rebuild(ft):
        def run():
            iv, sv = ft.evaluate()
            ft.frontier(iv, sv, warm=True)
            iv, sv = ft.evaluate(svals=sv)
            return ft.frontier(iv, sv, warm=True)
        return run
    ref, port = both(rebuild(fts[0]), rebuild(fts[1]))
    assert [s[0] for s in ref["spans"]] == ["frontier.evaluate",
                                            "frontier.dp"] * 2
    assert ref["spans"][-1][4]["warm"] is True


def test_builder_counters_and_repeat_evaluate_equal():
    """The builder's plain-int counters, and a second ``evaluate`` of one
    builder pushes nothing twice."""
    from repro.core.cost_tables import CostTableBuilder as JBuilder
    from repro.core.cost_tables import plan_chain_tables as j_tables
    from repro_torch.core.cost_tables import CostTableBuilder, \
        plan_chain_tables
    gj, gt = graphs("mobilenet", "small")
    tbj, tbt = (JTestbed(nodes=4, bandwidth_gbps=1.0),
                TorchTestbed(nodes=4, bandwidth_gbps=1.0))

    def run(builder_cls, tables, est, g, tb, schemes):
        def go():
            b = builder_cls(est, tb)
            tables(g.layers, b, schemes, 32, True, tb.nodes,
                   with_final=True)
            b.evaluate()
            b.evaluate()
            return (b.i_hits, b.i_misses, b.s_hits, b.s_misses,
                    b.i_entries, b.s_entries)
        return go
    from repro.core.partition import ALL_SCHEMES as JALL
    from repro_torch.core.partition import ALL_SCHEMES as TALL
    ref, port = both(run(JBuilder, j_tables, JEstimator(), gj, tbj, JALL),
                     run(CostTableBuilder, plan_chain_tables,
                         AnalyticEstimator(), gt, tbt, TALL))
    assert port["result"] == ref["result"]
    hits_i = ref["result"][0]
    assert ref["metrics"]["counters"][
        'cost_tables.dedup_hits{table="i"}'] == hits_i > 0


@pytest.mark.parametrize("gname,nodes", [("toy", 3), ("rb", 4)])
def test_prefetch_push_metrics_equal(gname, nodes):
    gj, gt = GRAPHS[gname]()
    tbj, tbt = (JTestbed(nodes=nodes, bandwidth_gbps=0.5),
                TorchTestbed(nodes=nodes, bandwidth_gbps=0.5))

    def run(pf_cls, search, cost, fixed, est, g, tb, schemes):
        def go():
            pf = pf_cls.for_graph(g, est, tb)
            # the scalar path: fixed plans and the oracle's own best plan
            # priced one query at a time through the prefetched view
            plan, best = search(g, est, tb)
            costs = [cost(g, fixed(g, s), pf, tb) for s in schemes]
            costs.append(cost(g, plan, pf, tb))
            pf.push_metrics()
            return pf.cache_info(), costs, best, steps(plan)
        return go
    from repro.core.partition import ALL_SCHEMES as JALL
    from repro.core.plan import fixed_plan as j_fixed, plan_cost as j_cost
    from repro_torch.core.partition import ALL_SCHEMES as TALL
    from repro_torch.core.plan import fixed_plan, plan_cost
    ref, port = both(run(JPrefetched, j_exhaustive, j_cost, j_fixed,
                         JEstimator(), gj, tbj, JALL),
                     run(PrefetchedEstimator, exhaustive_search, plan_cost,
                         fixed_plan, AnalyticEstimator(), gt, tbt, TALL))
    assert port["result"] == ref["result"]
    c = ref["metrics"]["counters"]
    assert c["prefetch.hits"] == ref["result"][0][0] > 0
    assert c["prefetch.misses"] == ref["result"][0][1]


# ---------------------------------------------------------------------------
# the refinement loop
# ---------------------------------------------------------------------------

class _Occ:
    failures = 0

    def __init__(self, dev, link):
        self.dev_occupancy_s = dev
        self.link_occupancy_s = link
        self.period_s = max(dev, link)


class _Bad(_Occ):
    failures = 2


def _flip():
    calls = {"n": 0}

    def flip(plan):
        calls["n"] += 1
        return (_Occ(10.0, 1e-3) if calls["n"] % 2 else _Occ(1e-3, 10.0))
    return flip


def _drift():
    calls = {"n": 0}

    def drift(plan):
        calls["n"] += 1
        return _Occ(0.5 + 1e-6 * calls["n"], 0.2)
    return drift


#: tests/test_elastic.py:355-405's occupancy functions, and the simulator
REFINE_CASES = {
    "flip-best": dict(occupancy_fn=_flip, max_iters=6),
    "drift-rel_tol": dict(occupancy_fn=_drift, rel_tol=1e-3, max_iters=5),
    "bad": dict(occupancy_fn=lambda: (lambda p: _Bad(0.5, 0.2)),
                max_iters=5),
    "simulator": dict(occupancy_fn=None, max_iters=4),
}


@pytest.mark.parametrize("case", sorted(REFINE_CASES))
def test_refine_gauges_and_ring_equal(case):
    gj, gt = toy_chain()
    cj, ct = clusters("stepped", 4)
    kw = dict(REFINE_CASES[case])
    make = kw.pop("occupancy_fn")

    def run(cl, g, c):
        def go():
            r = cl.refine_with_simulator(
                g, c, occupancy_fn=None if make is None else make(), **kw)
            return [plain(s) for s in r.steps], r.converged, steps(r.plan)
        return go
    ref, port = both(run(jcl, gj, cj), run(tcl, gt, ct))
    assert port["result"] == ref["result"]
    g = ref["metrics"]["gauges"]
    assert {'refine.beta{graph="toy"}', 'refine.alpha{graph="toy"}',
            'refine.period_s{graph="toy"}'} <= set(g)
    assert ref["metrics"]["counters"]['refine.iterations{graph="toy"}'] \
        == len(ref["result"][0])
    assert [e["kind"] for e in ref["ring"]] == \
        ["refine_step"] * len(ref["result"][0])


def test_refine_oscillation_postmortem_equal(tmp_path):
    gj, gt = toy_chain()
    cj, ct = clusters("stepped", 4)
    docs = {}
    for side, cl, g, c in (("ref", jcl, gj, cj), ("port", tcl, gt, ct)):
        obs = SIDES[side]
        d = tmp_path / side
        obs.set_postmortem_dir(str(d))

        def go():
            with pytest.raises(cl.RefineOscillationError):
                cl.refine_with_simulator(g, c, occupancy_fn=_flip(),
                                         on_oscillation="raise",
                                         max_iters=6)
        res = observed(side, go)
        obs.set_postmortem_dir(None)
        (path,) = sorted(d.glob("postmortem-*-refine_oscillation.json"))
        doc = json.loads(path.read_text())
        for e in doc["events"]:
            e.pop("t_us")
        # the tracer's tail: the frontier build's spans, without the clock
        doc["spans"] = [(sp["name"], sp["cat"], sp["track"], sp["args"])
                        for sp in doc["spans"]]
        docs[side] = (doc, res["metrics"], res["ring"])
    assert docs["port"] == docs["ref"]
    doc = docs["ref"][0]
    assert doc["reason"] == "refine_oscillation"
    assert [e["kind"] for e in doc["events"]][-1] == "refine_oscillation"
    assert doc["context"]["cycle"] == doc["events"][-1]["cycle"]


# ---------------------------------------------------------------------------
# the simulator's trace export
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gname,preset,nodes,n_requests", [
    ("toy", "stepped", 4, 1), ("toy", "mixed_fast_slow", 4, 5),
    ("rb", "stepped", 3, 3), ("mobilenet", "asym_uplink", 4, 4),
    ("bert", "mixed_fast_slow", 6, 2)])
def test_simulate_trace_json_bit_equal(gname, preset, nodes, n_requests,
                                       tmp_path):
    gj, gt = GRAPHS[gname]()
    cj, ct = clusters(preset, nodes)
    pt = tcl.cluster_plan_search(gt, ct,
                                 objective=tcl.Objective.THROUGHPUT).plan
    rep_j, tr_j = jcl.simulate_trace(gj, to_jplan(pt), cj,
                                     n_requests=n_requests)
    rep_t, tr_t = tcl.simulate_trace(gt, pt, ct, n_requests=n_requests)
    assert plain(rep_t) == plain(rep_j)
    assert tr_t.to_perfetto() == tr_j.to_perfetto()
    pj, ptt = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    jobs.write_trace(pj, tr_j)
    tobs.write_trace(ptt, tr_t)
    with open(pj, "rb") as a, open(ptt, "rb") as b:
        assert a.read() == b.read()
    stages = tobs.span_events(tobs.load_trace(ptt), cat=tobs.STAGE_CAT)
    assert stages and all(e["track"].startswith(("dev", "link"))
                          for e in stages)
    # the export of an explicit timeline, and the diff against itself
    stages_t = tcl.build_stages(gt, pt, ct)
    sim_t = tcl.simulate(gt, pt, ct, n_requests=2, record_timeline=True)
    exp = tcl.export_sim_trace(stages_t, sim_t.timeline, ct.n,
                               process="other", pid=7).to_perfetto()
    sim_j = jcl.simulate(gj, to_jplan(pt), cj, n_requests=2,
                         record_timeline=True)
    assert exp == jcl.export_sim_trace(
        jcl.build_stages(gj, to_jplan(pt), cj), sim_j.timeline, cj.n,
        process="other", pid=7).to_perfetto()
    d = tobs.diff_traces(exp, exp)
    assert d["structure_match"] and d["pairs"]


# ---------------------------------------------------------------------------
# GBDT logging
# ---------------------------------------------------------------------------

def _toy(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, size=(n, 5))
    y = (np.sin(x[:, 0]) + 0.5 * x[:, 1] ** 2 + (x[:, 2] > 0) * x[:, 3]
         + 0.05 * rng.normal(size=n))
    return x, y


@pytest.mark.parametrize("mode", ["1", "json", "0"])
def test_fit_verbose_lines_equal(mode, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_LOG", mode)
    x, y = _toy(1200, 3)
    ex, ey = _toy(300, 4)
    kw = dict(n_estimators=12, learning_rate=0.2, max_depth=4)
    lines = {}
    for side, make in (("ref", lambda: JGBDT(**kw)),
                       ("port", lambda: GBDTRegressor(**kw, device="cpu"))):
        make().fit(x, y, eval_set=(ex, ey), verbose_every=5)
        make().fit(x, y, verbose_every=4)
        out = capsys.readouterr()
        assert out.out == ""
        lines[side] = out.err
    assert lines["port"] == lines["ref"]
    n = len(lines["ref"].splitlines())
    assert n == (0 if mode == "0" else 2 + 3)
    if mode == "json":
        first = json.loads(lines["ref"].splitlines()[0])
        assert first["event"] == "gbdt.fit" and "eval_rmse" in first


def test_train_estimators_verbose_lines_equal(monkeypatch, capsys):
    monkeypatch.setenv("REPRO_LOG", "1")
    kw = dict(n_samples=600, seed=5)
    gb = dict(n_estimators=40, max_depth=3)
    est_j = jtrace.train_estimators(jtrace.TraceConfig(**kw), gb,
                                    verbose=True)
    ref = capsys.readouterr().err
    est_t = ttrace.train_estimators(ttrace.TraceConfig(**kw), gb,
                                    verbose=True, device="cpu")
    port = capsys.readouterr().err
    assert port == ref
    assert ref.count("[gbdt.fit] tree=40 ") == 2
    x = jtrace.generate_i_traces(jtrace.TraceConfig(n_samples=50, seed=9))[0]
    assert np.array_equal(est_t.i_model.predict(x), est_j.i_model.predict(x))
