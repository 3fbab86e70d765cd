"""The port's cluster specs, capability-weighted costs, simulator and
serving layer against the JAX package's ``repro.cluster``.

The same presets, layers and plans go to both packages; shard sizes,
per-device times, stage DAGs and ``SimReport``s must be equal bit for
bit (the reference side is numpy, so no tolerance applies).  Mirrors
``tests/test_cluster.py`` and the simulator and serving tests of the
reference.
"""
import dataclasses
import random

import numpy as np
import pytest

import repro.cluster as jcl
from repro.core import cost as jcost
from repro.core import partition as jpart
from repro.core import plan as jplan
from repro.core.cost_tables import pareto_front_2d as j_pareto_2d
from repro.core.cost_tables import pareto_front_nd as j_pareto_nd
from repro.core.estimator import i_features as j_i_features
from repro.core.estimator import s_features as j_s_features
from repro.runtime.decode import TransformerSpec as JSpec

import repro_torch.cluster as tcl
from repro_torch.core import AnalyticEstimator, Topology, plan_search
from repro_torch.core import Testbed as TorchTestbed
from repro_torch.core import cost as tcost
from repro_torch.core import partition as tpart
from repro_torch.core import plan as tplan
from repro_torch.core.cost_tables import pareto_front_2d, pareto_front_nd
from repro_torch.core.estimator import i_features, s_features
from repro_torch.core.partition import ALL_SCHEMES
from repro_torch.runtime.decode import TransformerSpec
from torch_cluster_pairs import (CLUSTERS, Occ, clusters, graphs, plain, steps,
                                 to_jplan, toy_chain, toy_dag)

PRESETS = sorted(tcl.CLUSTER_PRESETS)
MODELS = ("mobilenet", "resnet18", "resnet101", "inception", "bert")


def _jscheme(s):
    return jpart.Scheme(int(s))


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", PRESETS)
def test_presets_match(preset):
    for nodes in range(1, 9):
        jc, tc = clusters(preset, nodes)
        assert plain(tc) == plain(jc)
        assert plain(tc.compat_testbed()) == plain(jc.compat_testbed())
        for attr in ("n", "edges", "speeds_gflops", "dev_derates",
                     "capability_weights", "is_homogeneous",
                     "bottleneck_bw_gbps", "max_latency_us"):
            assert getattr(tc, attr) == getattr(jc, attr), (attr, nodes)


def test_topology_edges_match():
    for topo in Topology:
        for nodes in range(0, 9):
            assert tcl.topology_edges(nodes, topo) == \
                jcl.topology_edges(nodes, jcost.Topology(int(topo)))


def test_spec_validation_and_round_trip():
    with pytest.raises(ValueError):
        tcl.DeviceSpec(gflops=0.0)
    with pytest.raises(ValueError):
        tcl.LinkSpec(bandwidth_gbps=-1.0)
    with pytest.raises(ValueError):
        tcl.ClusterSpec(name="bad", devices=(tcl.DeviceSpec(),) * 4,
                        links=(tcl.LinkSpec(),) * 3)
    tb = TorchTestbed(nodes=5, bandwidth_gbps=2.0, topology=Topology.PS,
                      device_gflops=12.0, link_latency_us=7.0)
    cl = tcl.ClusterSpec.from_testbed(tb)
    assert cl.is_homogeneous and cl.compat_testbed() == tb


@pytest.mark.parametrize("name", MODELS)
def test_memory_ok_matches(name):
    gj, gt = graphs(name)
    for preset in PRESETS:
        for nodes in (2, 4, 6):
            jc, tc = clusters(preset, nodes)
            assert tc.memory_ok(gt) == jc.memory_ok(gj)


# ---------------------------------------------------------------------------
# Capability-weighted geometry and compute times (tests/test_cluster.py)
# ---------------------------------------------------------------------------

def test_weighted_split_sizes_match():
    for total in (1, 3, 7, 28, 224, 1000):
        for parts in (1, 2, 3, 4, 7, 16):
            assert tpart.weighted_split_sizes(total, [1.0] * parts) == \
                tpart.split_sizes(total, parts)
    for seed in range(40):
        rng = random.Random(seed)
        w = [rng.uniform(0.0, 8.0) for _ in range(rng.randint(2, 9))]
        total = rng.randint(1, 300)
        assert tpart.weighted_split_sizes(total, w) == \
            jpart.weighted_split_sizes(total, w)
    for bad in ([-1.0, 2.0], [0.0, 0.0]):
        with pytest.raises(ValueError):
            tpart.weighted_split_sizes(10, bad)


def test_weighted_split_batch_matches():
    rng = np.random.default_rng(0)
    for _ in range(20):
        w = rng.uniform(0.0, 8.0, size=rng.integers(2, 9))
        totals = rng.integers(1, 300, size=40)
        got = tpart.weighted_split_batch(totals, w)
        assert np.array_equal(got, jpart.weighted_split_batch(totals, w))
        for row, t in zip(got, totals):
            assert list(row) == tpart.weighted_split_sizes(int(t), list(w))


def _layer_pairs():
    """(reference layer, port layer) of the toy graphs and every full-size
    edge model (deduplicated by value)."""
    seen = set()
    out = []
    pairs = [toy_chain(), toy_dag()] + [graphs(m) for m in MODELS]
    for gj, gt in pairs:
        for lj, lt in zip(gj.layers, gt.layers):
            key = dataclasses.astuple(lt)
            if key not in seen:
                seen.add(key)
                out.append((lj, lt))
    return out


@pytest.mark.parametrize("preset", PRESETS)
def test_hetero_shard_work_matches(preset):
    for nodes in (2, 3, 4, 6):
        jc, tc = clusters(preset, nodes)
        w = tc.capability_weights
        for lj, lt in _layer_pairs():
            for s in ALL_SCHEMES:
                for halo in ((0, 1, 2) if s.spatial else (0,)):
                    got = tpart.hetero_shard_work(lt, s, w, extra_halo=halo)
                    want = jpart.hetero_shard_work(lj, _jscheme(s), w,
                                                   extra_halo=halo)
                    assert plain(got) == plain(want), (lt.name, s, halo)
    lt = toy_chain()[1].layers[0]
    with pytest.raises(ValueError):
        tpart.hetero_shard_work(lt, tpart.Scheme.OUTC, [1.0, 2.0],
                                extra_halo=1)


@pytest.mark.parametrize("preset", PRESETS)
def test_hetero_compute_times_match(preset):
    """Scalar per-device and straggler times and the batched form, on the
    same rows, bit-equal to the reference's; the batch also bit-equal to
    the port's own scalar calls."""
    rng = np.random.default_rng(1)
    for nodes in (2, 4, 6):
        jc, tc = clusters(preset, nodes)
        jtb, ttb = jc.compat_testbed(), tc.compat_testbed()
        args = (np.asarray(tc.speeds_gflops), np.asarray(tc.dev_derates),
                np.asarray(tc.capability_weights))
        rows, jrows, factors, want = [], [], [], []
        for lj, lt in _layer_pairs():
            for s in ALL_SCHEMES:
                halo = int(rng.integers(0, 3)) if s.spatial else 0
                dev = tcost.hetero_device_times_s(lt, s, ttb, *args,
                                                  extra_halo=halo)
                assert np.array_equal(dev, jcost.hetero_device_times_s(
                    lj, _jscheme(s), jtb, *args, extra_halo=halo))
                t = tcost.hetero_compute_time_s(lt, s, ttb, *args,
                                                extra_halo=halo)
                assert t == jcost.hetero_compute_time_s(
                    lj, _jscheme(s), jtb, *args, extra_halo=halo)
                rows.append(i_features(lt, s, ttb, halo))
                jrows.append(j_i_features(lj, _jscheme(s), jtb, halo))
                factors.append(lt.extra_flop_factor)
                want.append(t)
        assert np.array_equal(np.asarray(rows), np.asarray(jrows))
        got = tcost.hetero_compute_time_batch_s(
            np.asarray(rows), ttb, *args, np.asarray(factors))
        assert np.array_equal(got, np.asarray(want))
        assert np.array_equal(got, jcost.hetero_compute_time_batch_s(
            np.asarray(rows), jtb, *args, np.asarray(factors)))


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("preset", PRESETS)
def test_cluster_estimator_matches(preset, weighted):
    """``ClusterAnalyticEstimator``'s scalar and batched i- and s-costs
    and its per-device times equal the reference's."""
    for nodes in (2, 4, 6):
        jc, tc = clusters(preset, nodes)
        je = jcl.ClusterAnalyticEstimator(jc, weighted=weighted)
        te = tcl.ClusterAnalyticEstimator(tc, weighted=weighted)
        jtb, ttb = jc.compat_testbed(), tc.compat_testbed()
        irows, srows = [], []
        pairs = _layer_pairs()
        for (lj, lt), (nj, nt) in zip(pairs, pairs[1:] + [(None, None)]):
            for s in ALL_SCHEMES:
                js = _jscheme(s)
                assert te.i_cost(lt, s, ttb) == je.i_cost(lj, js, jtb)
                assert np.array_equal(te.device_times(lt, s),
                                      je.device_times(lj, js))
                irows.append(i_features(lt, s, ttb, 0))
                assert te.s_cost(lt, None, s, None, ttb) == \
                    je.s_cost(lj, None, js, None, jtb)
                if nt is not None:
                    for d in ALL_SCHEMES:
                        assert te.s_cost(lt, nt, s, d, ttb) == \
                            je.s_cost(lj, nj, js, _jscheme(d), jtb)
                        srows.append(s_features(lt, nt, s, d, ttb))
                        assert srows[-1] == j_s_features(
                            lj, nj, js, _jscheme(d), jtb)
        X, S = np.asarray(irows), np.asarray(srows)
        assert np.array_equal(te.i_cost_batch(X, ttb),
                              je.i_cost_batch(X, jtb))
        assert np.array_equal(te.s_cost_batch(S, ttb),
                              je.s_cost_batch(S, jtb))
        with pytest.raises(ValueError):
            te.i_cost(pairs[0][1], tpart.Scheme.INH, TorchTestbed(nodes=7))


# ---------------------------------------------------------------------------
# Homogeneous clusters == the port's Testbed path, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nodes", [2, 3, 4, 5, 8, 13, 16])
def test_homogeneous_cluster_bit_parity(nodes):
    """``ClusterAnalyticEstimator`` on ``homogeneous(n)`` equals the port's
    ``AnalyticEstimator`` in every scalar and batched cost and in the
    searched plan and cost, as the reference's does."""
    est = AnalyticEstimator()
    cl = tcl.homogeneous(nodes, bandwidth_gbps=1.0)
    ce = tcl.ClusterAnalyticEstimator(cl)
    tb = cl.compat_testbed()
    assert tb == TorchTestbed(nodes=nodes, bandwidth_gbps=1.0)
    ls = toy_chain()[1].layers
    irows, srows = [], []
    for l, nxt in zip(ls, list(ls[1:]) + [None]):
        for s in ALL_SCHEMES:
            assert ce.i_cost(l, s, tb) == est.i_cost(l, s, tb)
            irows.append(i_features(l, s, tb, 0))
            assert ce.s_cost(l, None, s, None, tb) == \
                est.s_cost(l, None, s, None, tb)
            if nxt is not None:
                for d in ALL_SCHEMES:
                    assert ce.s_cost(l, nxt, s, d, tb) == \
                        est.s_cost(l, nxt, s, d, tb)
                    srows.append(s_features(l, nxt, s, d, tb))
    X, S = np.asarray(irows), np.asarray(srows)
    assert np.array_equal(ce.i_cost_batch(X, tb), est.i_cost_batch(X, tb))
    assert np.array_equal(ce.s_cost_batch(S, tb), est.s_cost_batch(S, tb))
    g = graphs("mobilenet")[1]
    ref = plan_search(g, est, tb)
    got = tcl.cluster_plan_search(g, cl)
    assert got.plan == ref.plan and got.cost == ref.cost


# ---------------------------------------------------------------------------
# Pipelined plan costs, stage counts and the Pareto reductions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_pipeline_cost_and_stage_counts_match(name):
    gj, gt = graphs(name)
    for preset, nodes in CLUSTERS:
        jc, tc = clusters(preset, nodes)
        te = tcl.ClusterAnalyticEstimator(tc)
        je = jcl.ClusterAnalyticEstimator(jc)
        pt = tcl.cluster_plan_search(gt, tc).plan
        pj = to_jplan(pt)
        got = tplan.plan_pipeline_cost(gt, pt, te, tc.compat_testbed())
        want = jplan.plan_pipeline_cost(gj, pj, je, jc.compat_testbed())
        assert plain(got) == plain(want)
        assert (got.bottleneck_s, got.latency_s, got.throughput_rps) == \
            (want.bottleneck_s, want.latency_s, want.throughput_rps)
        assert tplan.plan_stage_counts(gt, pt) == \
            jplan.plan_stage_counts(gj, pj)
    for a in range(len(gt)):
        for b in range(a, min(a + 4, len(gt))):
            assert tplan.segment_halos(gt.layers, a, b) == \
                jplan.segment_halos(gj.layers, a, b)


def test_pareto_reductions_match():
    """Ties and duplicates collapse to the same first occurrences."""
    rng = np.random.default_rng(3)
    for trial in range(200):
        m = int(rng.integers(1, 40))   # callers never pass an empty set
        a = rng.integers(0, 8, m).astype(np.float64)
        b = rng.integers(0, 8, m).astype(np.float64)
        for ub in (float("inf"), 5.0, 0.5):
            got = pareto_front_2d(a, b, ub)
            assert np.array_equal(got, j_pareto_2d(a, b, ub))
        cols = [rng.integers(0, 4, m).astype(np.float64) for _ in range(3)]
        assert np.array_equal(pareto_front_nd(cols), j_pareto_nd(cols))


# ---------------------------------------------------------------------------
# The discrete-event simulator
# ---------------------------------------------------------------------------

def _plans(gt, tc):
    """The port's latency, throughput and P99-bounded plans."""
    out = []
    lat = tcl.cluster_plan_search(gt, tc)
    out.append(lat.plan)
    out.append(tcl.cluster_plan_search(
        gt, tc, objective=tcl.Objective.THROUGHPUT).plan)
    out.append(tcl.cluster_plan_search(
        gt, tc, objective=tcl.Objective.P99_BOUNDED,
        latency_bound_s=lat.cost * 1.2).plan)
    return out


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("name", MODELS)
def test_build_stages_match(name, weighted):
    gj, gt = graphs(name)
    for preset, nodes in CLUSTERS:
        jc, tc = clusters(preset, nodes)
        for pt in _plans(gt, tc):
            for batch in (1, 3):
                got = tcl.build_stages(gt, pt, tc, weighted=weighted,
                                       batch_size=batch)
                want = jcl.build_stages(gj, to_jplan(pt), jc,
                                        weighted=weighted, batch_size=batch)
                assert plain(got) == plain(want), (preset, nodes, batch)
    with pytest.raises(ValueError):
        tcl.build_stages(gt, pt, tc, batch_size=0)


SIM_CASES = (
    dict(n_requests=1),
    dict(n_requests=16),
    dict(n_requests=12, warmup=5),
    dict(n_requests=9, batch_size=4),
    dict(n_requests=10, record_timeline=True),
    dict(n_requests=17, weighted=False),
)


@pytest.mark.parametrize("open_loop", [False, True],
                         ids=["closed", "open"])
@pytest.mark.parametrize("name", MODELS)
def test_simulate_matches(name, open_loop):
    """SimReport field for field — latencies, p50, the p99 order
    statistic, throughput, per-device and per-link busy seconds and the
    recorded timeline — under closed (all queued at t=0) and open
    (evenly spaced) arrivals."""
    gj, gt = graphs(name)
    for preset, nodes in CLUSTERS:
        jc, tc = clusters(preset, nodes)
        pt = tcl.cluster_plan_search(
            gt, tc, objective=tcl.Objective.THROUGHPUT).plan
        pj = to_jplan(pt)
        period = 0.0
        if open_loop:
            # arrivals a little faster than one request's latency, so
            # the open queue both idles and backs up
            one = tcl.simulate(gt, pt, tc)
            period = one.makespan_s * 0.37
        for kw in SIM_CASES:
            got = tcl.simulate(gt, pt, tc, arrival_period_s=period, **kw)
            want = jcl.simulate(gj, pj, jc, arrival_period_s=period, **kw)
            assert plain(got) == plain(want), (preset, nodes, kw)
            assert got.timeline == want.timeline
            assert got.device_utilization == want.device_utilization


# ---------------------------------------------------------------------------
# Serving (tests/test_serving.py, tests/test_hetero_estimator.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mobilenet", "resnet18"])
def test_serving_matches(name):
    gj, gt = graphs(name, "test")
    for preset, nodes in (("mixed_fast_slow", 4), ("uniform", 4)):
        jc, tc = clusters(preset, nodes)
        pt = tcl.cluster_plan_search(
            gt, tc, objective=tcl.Objective.THROUGHPUT).plan
        pj = to_jplan(pt)
        cap = tcl.simulate(gt, pt, tc, n_requests=8).throughput_rps
        bound = 3.0 * tcl.simulate(gt, pt, tc).makespan_s
        rates = [cap * f for f in (0.3, 0.8, 1.5, 4.0)]
        for rate in rates[:2]:
            for b in (1, 2, 4):
                assert plain(tcl.serve_point(gt, pt, tc, rate, b, bound,
                                             n_batches=12)) == \
                    plain(jcl.serve_point(gj, pj, jc, rate, b, bound,
                                          n_batches=12))
        for rate in rates:
            best, pts = tcl.choose_batch(gt, pt, tc, rate, bound,
                                         n_batches=12)
            jbest, jpts = jcl.choose_batch(gj, pj, jc, rate, bound,
                                           n_batches=12)
            assert plain(best) == plain(jbest)
            assert plain(pts) == plain(jpts)
        rows = tcl.sweep_serving(gt, pt, tc, rates, bound, n_batches=12)
        assert rows == jcl.sweep_serving(gj, pj, jc, rates, bound,
                                         n_batches=12)
        assert tcl.max_goodput(gt, pt, tc, rates, bound, n_batches=12) == \
            jcl.max_goodput(gj, pj, jc, rates, bound, n_batches=12)
        for rate in (rates[0] * 0.5, rates[1], rates[2], rates[3] * 2):
            for service in (None, bound / 10):
                assert tcl.fold_queueing_delay(
                    bound, rows, rate, service_p99_s=service) == \
                    jcl.fold_queueing_delay(bound, rows, rate,
                                            service_p99_s=service)
    with pytest.raises(ValueError):
        tcl.serve_point(gt, pt, tc, 0.0, 1, bound)
    with pytest.raises(ValueError):
        tcl.fold_queueing_delay(0.0, rows, 1.0)
    assert tcl.fold_queueing_delay(0.5, [], 10.0) == 0.5


def test_fold_queueing_delay_values():
    rows = [{"arrival_rate_rps": 10.0, "p99_ms": 100.0},
            {"arrival_rate_rps": 20.0, "p99_ms": 150.0}]
    for args in ((0.5, rows, 10.0), (0.5, rows, 15.0), (0.5, rows, 100.0),
                 (0.04, rows, 20.0)):
        assert tcl.fold_queueing_delay(*args) == \
            jcl.fold_queueing_delay(*args)
    assert tcl.fold_queueing_delay(0.5, rows, 10.0, service_p99_s=0.05) \
        == jcl.fold_queueing_delay(0.5, rows, 10.0, service_p99_s=0.05)


@pytest.mark.parametrize("preset", ["uniform", "mixed_fast_slow"])
def test_decode_serving_matches(preset):
    """The prefill/decode split plans (over the port's own decode graphs)
    and the continuous-batching event loop equal the reference's."""
    kw = dict(n_layers=2, d_model=256, n_heads=8, d_ff=1024, vocab=512)
    ts, js = TransformerSpec(**kw), JSpec(**kw)
    jc, tc = clusters(preset, 4)
    pre, dec = tcl.plan_decode_serving(ts, tc, prompt_len=64, n_new=16)
    jpre, jdec = jcl.plan_decode_serving(js, jc, prompt_len=64, n_new=16)
    for got, want in ((pre, jpre), (dec, jdec)):
        assert steps(got.plan) == steps(want.plan)
        assert got.cost == want.cost
    for rate in (5.0, 50.0, 500.0):
        for max_batch in (1, 4):
            got = tcl.serve_decode(ts, tc, prompt_len=64, n_new=16,
                                   arrival_rate_rps=rate, n_requests=10,
                                   max_batch=max_batch)
            want = jcl.serve_decode(js, jc, prompt_len=64, n_new=16,
                                    arrival_rate_rps=rate, n_requests=10,
                                    max_batch=max_batch)
            assert plain(got) == plain(want)
    with pytest.raises(ValueError):
        tcl.serve_decode(ts, tc, prompt_len=64, n_new=16,
                         arrival_rate_rps=0.0)
    with pytest.raises(ValueError):
        tcl.serve_decode(ts, tc, prompt_len=64, n_new=0,
                         arrival_rate_rps=1.0)


def test_measured_occupancy_carries_the_refine_hand_off():
    """The names the package exports resolve, and the port's
    ``MeasuredOccupancy`` carries every field the refinement loop and the
    calibrator read from a scripted sample."""
    from repro_torch.runtime.engine import MeasuredOccupancy
    occ = MeasuredOccupancy(dev_occupancy_s=2e-3, link_occupancy_s=1e-3,
                            period_s=2e-3, latency_s=3e-3)
    fake = Occ(2e-3, 1e-3)
    for attr in ("dev_occupancy_s", "link_occupancy_s", "period_s",
                 "failures"):
        assert getattr(occ, attr) == getattr(fake, attr)
    assert set(tcl.__all__) <= set(dir(tcl))
