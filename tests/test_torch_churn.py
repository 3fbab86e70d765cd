"""The port's churn scenarios and strategy replay
(``repro_torch.cluster.churn``) against the JAX package's, in one process.

* The reference's ``tests/test_churn.py`` cases of the cluster module run
  on the port (its source executed again with ``repro`` imports
  redirected, ``torch_ref_cases``); its Hypothesis property is not run
  (it draws fresh seeds), and its ``check_regression`` cases test a
  benchmark script, not the cluster package.
* Scenarios equal event for event on seeds 0-63 for every generator.
* ``random_scenario``'s fault of the reference's own (a fresh device that
  arrives, departs and arrives again raises ``StopIteration``) is kept:
  both packages raise on seeds 3137, 3915 and 7673.
* ``run_churn`` and ``compare_strategies`` results equal field for field,
  timelines included, under one fake wall clock given to both packages'
  ``cluster.elastic`` (the replay reads the planner's wall time).
* The membership property on fixed seeds where both generate.
"""
import itertools
import types

import pytest

import repro.cluster.churn as jch
import repro.cluster.elastic as jel
import repro.obs as jobs
import repro_torch.cluster.churn as tch
import repro_torch.cluster.elastic as tel
import repro_torch.obs as tobs
import test_churn as ref_tests
from torch_cluster_pairs import clusters, graphs, plain, toy_chain
from torch_ref_cases import port_namespace, run_case

PORT = port_namespace("test_churn")
REF_NS = vars(ref_tests)
CASES = ("test_event_validation", "test_scenario_sorts_and_bounds_events",
         "test_generators_are_seed_deterministic",
         "test_random_scenario_guarantees_a_departure_and_valid_kinds",
         "test_run_churn_rejects_unknown_strategy",
         "test_strategy_structure_under_mixed_churn",
         "test_flap_hits_the_frontier_cache",
         "test_shared_sim_cache_changes_nothing",
         "test_membership_property_fixed_seeds")

#: seeds on which ``random_scenario(stepped(4), seed, n_events=5)`` lets a
#: fresh device arrive, depart and arrive again (ROADMAP C)
FAILING_SEEDS = (3137, 3915, 7673)


def test_the_reference_module_runs_on_the_port():
    assert PORT["run_churn"] is tch.run_churn
    assert PORT["ElasticPlanner"] is tel.ElasticPlanner
    assert set(CASES) <= set(PORT)


@pytest.mark.parametrize("name", CASES)
def test_reference_case_holds_on_the_port(name, request):
    run_case(PORT, name, request)


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

def _events(pkg, gen, cluster, seed, **kw):
    try:
        scen = getattr(pkg, gen)(cluster, seed=seed, **kw)
    except StopIteration:
        return "StopIteration"
    return (scen.name, scen.horizon_s, scen.n_departures, plain(scen.events))


@pytest.mark.parametrize("preset,nodes", [("stepped", 4),
                                          ("mixed_fast_slow", 4),
                                          ("stepped", 3)])
def test_scenarios_equal_event_for_event(preset, nodes):
    cj, ct = clusters(preset, nodes)
    raised = []
    for gen, kw in (("scenario_mixed", {}), ("scenario_flap", {}),
                    ("scenario_crash_only", {}), ("random_scenario", {}),
                    ("random_scenario", {"n_events": 5}),
                    ("random_scenario", {"n_events": 9,
                                         "ensure_departure": False,
                                         "horizon_s": 25.0})):
        for seed in range(64):
            want = _events(jch, gen, cj, seed, **kw)
            assert _events(tch, gen, ct, seed, **kw) == want, \
                (gen, kw, seed)
            if want == "StopIteration":
                raised.append((gen, seed))
    assert not [r for r in raised if r[0] != "random_scenario"]


@pytest.mark.parametrize("seed", FAILING_SEEDS)
def test_random_scenario_fault_is_the_references(seed):
    """A fresh device ``x<k>`` that arrives, departs and arrives again:
    the re-arrival looks it up in ``cluster.devices`` and both packages
    raise ``StopIteration``; the membership property cannot run there."""
    cj, ct = clusters("stepped", 4)
    for pkg, c in ((jch, cj), (tch, ct)):
        with pytest.raises(StopIteration):
            pkg.random_scenario(c, seed=seed, n_events=5)
    for ns in (REF_NS, PORT):
        with pytest.raises(StopIteration):
            ns["_check_membership_property"](seed)


# ---------------------------------------------------------------------------
# strategy replay
# ---------------------------------------------------------------------------

@pytest.fixture
def shared_clock(monkeypatch):
    """One deterministic wall clock (a step of 0.5 ms a call), a copy for
    each package's ``cluster.elastic``."""
    def install():
        for m in (jel, tel):
            ticks = itertools.count()
            monkeypatch.setattr(m, "time", types.SimpleNamespace(
                perf_counter=lambda t=ticks: 5.0 + 5e-4 * next(t)))
    install()
    return install


RUNS = (("toy", "stepped", 4, "scenario_mixed", 0),
        ("toy", "stepped", 3, "scenario_mixed", 1),
        ("toy", "stepped", 4, "scenario_flap", 0),
        ("toy", "mixed_fast_slow", 4, "scenario_crash_only", 2),
        ("toy", "stepped", 4, "random_scenario", 5),
        ("mobilenet", "mixed_fast_slow", 4, "scenario_flap", 0),
        ("mobilenet", "stepped", 4, "scenario_mixed", 0))


def _graphs(name):
    return toy_chain() if name == "toy" else graphs(name, "small")


@pytest.mark.parametrize("gname,preset,nodes,gen,seed", RUNS)
def test_compare_strategies_equal_field_for_field(gname, preset, nodes, gen,
                                                  seed, shared_clock):
    gj, gt = _graphs(gname)
    cj, ct = clusters(preset, nodes)
    got = {}
    for side, pkg, obs, g, c in (("ref", jch, jobs, gj, cj),
                                 ("port", tch, tobs, gt, ct)):
        shared_clock()
        scen = getattr(pkg, gen)(c, seed=seed)
        tr = obs.set_tracer(obs.Tracer())
        mx = obs.set_metrics(obs.Metrics())
        try:
            res = pkg.compare_strategies(g, c, scen, heartbeat_interval_s=1.0,
                                         dead_misses=3)
        finally:
            obs.set_tracer(None)
            obs.set_metrics(None)
        got[side] = dict(
            results={k: plain(v) for k, v in res.items()},
            metrics=mx.snapshot(),
            instants=[(e["name"], e["args"]) for e in tr._records
                      if e["ph"] == "i"],
            spans=[s["name"] for s in tr.spans()])
    assert got["port"]["results"] == got["ref"]["results"]
    assert got["port"]["metrics"] == got["ref"]["metrics"]
    assert got["port"]["instants"] == got["ref"]["instants"]
    assert got["port"]["spans"] == got["ref"]["spans"]
    res = got["ref"]["results"]
    assert set(res) == {"never", "scratch", "incremental"}
    assert res["incremental"]["n_replans"] > 0
    assert [n for n, _ in got["ref"]["instants"]].count("detect") == \
        res["scratch"]["n_replans"] + res["incremental"]["n_replans"]


def test_run_churn_knobs_equal(shared_clock):
    gj, gt = toy_chain()
    cj, ct = clusters("stepped", 4)
    for strategy, kw in itertools.product(
            ("never", "scratch", "incremental"),
            ({"heartbeat_interval_s": 0.5, "suspect_misses": 1,
              "dead_misses": 2}, {"horizon_requests": 5.0, "inflight": 0},
             {"weighted": False, "n_sim_requests": 6})):
        shared_clock()
        want = jch.run_churn(gj, cj, jch.scenario_mixed(cj, seed=4),
                             strategy, **kw)
        shared_clock()
        got = tch.run_churn(gt, ct, tch.scenario_mixed(ct, seed=4),
                            strategy, **kw)
        assert plain(got) == plain(want), (strategy, kw)


#: fixed seeds of the membership property, the reference's three first
MEMBERSHIP_SEEDS = (0, 7, 42, 1, 2, 3, 5, 11, 64, 100, 999, 2024, 4096,
                    9999, 10000)


@pytest.mark.parametrize("seed", MEMBERSHIP_SEEDS)
def test_membership_property_fixed_seeds(seed):
    cj, ct = clusters("stepped", 4)
    want = _events(jch, "random_scenario", cj, seed, n_events=5)
    assert want != "StopIteration"
    assert _events(tch, "random_scenario", ct, seed, n_events=5) == want
    REF_NS["_check_membership_property"](seed)
    PORT["_check_membership_property"](seed)
