"""The port's learned estimators — ``GBDTEstimator``, ``hetero_summary``,
``ClusterGBDTEstimator`` and ``train_estimators`` — against the JAX
package's, on CPU tensors.

The GBDT cases of ``tests/test_gbdt.py`` and ``tests/test_hetero_estimator.py``
run against the port with the small ``trained`` fixture (which is the
reference's forests bit for bit: the port's fit reproduces them).  Then
forests carried over from the reference plan in the port: ``plan_search``
and ``cluster_plan_search`` return the reference's plan (steps equal by
enum value) and its cost to the bit, on MobileNet, ResNet-18 and bert at
the test widths.
"""
import numpy as np
import pytest
import torch

import repro.cluster as jcl
from repro.core import GBDTEstimator as JGBDTEstimator
from repro.core import Testbed as JTestbed
from repro.core import hetero_summary as j_hetero_summary
from repro.core.dpp import plan_search as j_plan_search
from repro.core.dpp import plan_search_reference as j_plan_search_reference
from repro.gbdt import GBDTRegressor as JGBDT
from repro.sim import (TraceConfig as JTraceConfig,
                       hetero_trace_config as j_hetero_config,
                       train_estimators as j_train)

import repro_torch.cluster as tcl
from repro_torch.cluster import (ClusterAnalyticEstimator,
                                 ClusterGBDTEstimator, cluster_plan_search,
                                 mixed_fast_slow, stepped)
from repro_torch.configs.edge_models import resnet18
from repro_torch.core import (GBDTEstimator, HETERO_FEATURE_NAMES,
                              I_FEATURE_NAMES, N_HETERO_FEATURES,
                              S_FEATURE_NAMES, AnalyticEstimator, Scheme,
                              hetero_summary, plan_search,
                              plan_search_reference)
from repro_torch.core import Testbed as TorchTestbed
from repro_torch.core import testbed_summary as uniform_summary
from repro_torch.core.estimator import i_features, latency_class, s_features
from repro_torch.core.graph import ConvT, LayerSpec
from repro_torch.core.plan import plan_cost
from repro_torch.gbdt import GBDTRegressor
from repro_torch.sim import (TraceConfig, generate_i_traces,
                             hetero_trace_config, train_estimators)
from repro_torch.sim.trace import _random_layer, _random_testbed
from torch_cluster_pairs import clusters, graphs, steps


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """A CPU fit is thousands of small tensor ops.  Beside the other test
    workers, intra-op threads only contend (six processes of eight threads
    made a fit ~100x slower), so this module runs them in one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KW = dict(n_estimators=25, max_depth=6)


def _carry(forest) -> GBDTRegressor:
    """A reference forest's node arrays in a CPU port forest."""
    return GBDTRegressor.from_arrays(
        forest.base_, forest.learning_rate,
        [t.flat() for t in forest.trees_], forest.n_features_, device="cpu")


def _same_forest(a, b) -> bool:
    return (a.base_, a.learning_rate, a.n_features_) == \
        (b.base_, b.learning_rate, b.n_features_) and \
        len(a.trees_) == len(b.trees_) and \
        all(np.array_equal(p, q) for ta, tb in zip(a.trees_, b.trees_)
            for p, q in zip(ta.flat(), tb.flat()))


@pytest.fixture(scope="module")
def ref_trained():
    """The reference's small hetero-trained + homogeneous-trained pair
    (``tests/test_hetero_estimator.py::trained``)."""
    het = j_train(j_hetero_config(n_samples=6000, seed=0,
                                  hetero_fraction=0.7), gbdt_kwargs=KW)
    hom = j_train(JTraceConfig(n_samples=6000, seed=0), gbdt_kwargs=KW)
    return het, hom


@pytest.fixture(scope="module")
def trained(ref_trained):
    """The same pair trained by the port on CPU tensors; it must be the
    reference's forests bit for bit."""
    het = train_estimators(
        hetero_trace_config(n_samples=6000, seed=0, hetero_fraction=0.7),
        gbdt_kwargs=KW, device="cpu")
    hom = train_estimators(TraceConfig(n_samples=6000, seed=0),
                           gbdt_kwargs=KW, device="cpu")
    return het, hom


def test_train_estimators_equals_the_reference(trained, ref_trained):
    for port, ref in zip(trained, ref_trained):
        assert _same_forest(ref.i_model, port.i_model)
        assert _same_forest(ref.s_model, port.s_model)


def test_verbose_training_waits_for_the_obs_port():
    with pytest.raises(NotImplementedError, match="A 6.2"):
        train_estimators(TraceConfig(n_samples=100), verbose=True,
                         gbdt_kwargs=dict(n_estimators=2), device="cpu")


# ---------------------------------------------------------------------------
# tests/test_gbdt.py's estimator cases against the port
# ---------------------------------------------------------------------------

def test_gbdt_estimator_batch_bit_matches_scalar():
    """GBDTEstimator.i_cost_batch / s_cost_batch equal the scalar protocol
    exactly (one exp(predict) per row either way)."""
    rng = np.random.default_rng(11)
    xi = rng.uniform(0, 200, size=(1200, 16))
    xs = rng.uniform(0, 200, size=(1200, 18))
    kw = dict(n_estimators=10, max_depth=4, device="cpu")
    est = GBDTEstimator(
        GBDTRegressor(**kw).fit(xi, rng.normal(size=1200)),
        GBDTRegressor(**kw).fit(xs, rng.normal(size=1200)))
    cfg = TraceConfig()
    irows, srows, i_want, s_want = [], [], [], []
    for _ in range(100):
        layer = _random_layer(rng)
        tb = _random_testbed(rng, cfg)
        sch = Scheme(int(rng.integers(0, 4)))
        halo = int(rng.integers(0, 4)) if sch.spatial else 0
        irows.append(i_features(layer, sch, tb, halo))
        i_want.append(est.i_cost(layer, sch, tb, extra_halo=halo))
        nxt = _random_layer(rng)
        dst = Scheme(int(rng.integers(0, 4)))
        srows.append(s_features(layer, nxt, sch, dst, tb))
        s_want.append(est.s_cost(layer, nxt, sch, dst, tb))
    tb = TorchTestbed()
    assert np.array_equal(est.i_cost_batch(np.asarray(irows), tb),
                          np.asarray(i_want))
    assert np.array_equal(est.s_cost_batch(np.asarray(srows), tb),
                          np.asarray(s_want))


def test_estimator_training_end_to_end():
    """Traces -> GBDT -> DPP: plan must stay near the analytic optimum,
    and be the reference's plan at the reference's cost."""
    from repro_torch.configs.edge_models import mobilenet_v1
    cfg = dict(n_samples=4000, seed=3)
    gkw = dict(n_estimators=40, max_depth=6)
    est = train_estimators(TraceConfig(**cfg), gbdt_kwargs=gkw,
                           device="cpu")
    g = mobilenet_v1()
    tb = TorchTestbed(nodes=4, bandwidth_gbps=1.0)
    res = plan_search(g, est, tb)
    true_cost = plan_cost(g, res.plan, AnalyticEstimator(), tb)
    opt = plan_search(g, AnalyticEstimator(), tb).cost
    assert true_cost <= opt * 1.30   # within 30% of optimal (small GBDT)
    jg = graphs("mobilenet")[0]
    jres = j_plan_search(jg, j_train(JTraceConfig(**cfg), gbdt_kwargs=gkw),
                         JTestbed(nodes=4, bandwidth_gbps=1.0))
    assert steps(res.plan) == steps(jres.plan)
    assert res.cost == jres.cost


# ---------------------------------------------------------------------------
# tests/test_hetero_estimator.py's GBDT cases against the port
# ---------------------------------------------------------------------------

def test_feature_prefix_exact():
    layer = LayerSpec("c", ConvT.CONV, 28, 28, 16, 32, 3, 1, 1)
    nxt = LayerSpec("n", ConvT.POINTWISE, 28, 28, 32, 64, 1, 1, 0)
    tb = TorchTestbed(nodes=4, bandwidth_gbps=1.0)
    summary = hetero_summary([1.0, 2.0, 3.0, 4.0], [0.5, 1.0], 10.0)
    assert summary == j_hetero_summary([1.0, 2.0, 3.0, 4.0], [0.5, 1.0],
                                       10.0)
    base_i = i_features(layer, Scheme.INH, tb, 1)
    wide_i = i_features(layer, Scheme.INH, tb, 1, hetero=summary)
    assert len(base_i) == len(I_FEATURE_NAMES) == 17
    assert len(wide_i) == 17 + N_HETERO_FEATURES
    assert wide_i[:17] == base_i and wide_i[17:] == summary
    base_s = s_features(layer, nxt, Scheme.INH, Scheme.OUTC, tb)
    wide_s = s_features(layer, nxt, Scheme.INH, Scheme.OUTC, tb,
                        hetero=summary)
    assert len(base_s) == len(S_FEATURE_NAMES) == 20
    assert wide_s[:20] == base_s and wide_s[20:] == summary
    assert len(HETERO_FEATURE_NAMES) == N_HETERO_FEATURES == 5


def test_hetero_summary_values_and_validation():
    n = 4
    tb = TorchTestbed(nodes=n)
    uni = uniform_summary(tb)
    assert uni[:3] == [1.0 / n] * 3 and uni[3] == 1.0
    assert uni[4] == latency_class(tb.link_latency_us)
    s = hetero_summary([1.0, 3.0], [0.25, 1.0], 100.0)
    assert s[0] == 0.25 and s[2] == 0.75 and abs(s[1] - 0.5) < 1e-15
    assert s[3] == 0.25 and s[4] == 2.0
    with pytest.raises(ValueError):
        hetero_summary([1.0, 0.0], [1.0], 10.0)


@pytest.mark.parametrize("preset", ["mixed_fast_slow", "stepped",
                                    "asym_uplink"])
def test_cluster_summary_matches_the_reference(preset):
    jc, tc = clusters(preset, 5)
    want = j_hetero_summary(jc.capability_weights,
                            [lk.bandwidth_gbps for lk in jc.links],
                            jc.max_latency_us)
    assert hetero_summary(tc.capability_weights,
                          [lk.bandwidth_gbps for lk in tc.links],
                          tc.max_latency_us) == want


def test_forest_records_fit_width(trained):
    het, hom = trained
    assert het.i_model.n_features_ == 17 + N_HETERO_FEATURES
    assert het.s_model.n_features_ == 20 + N_HETERO_FEATURES
    assert hom.i_model.n_features_ == 17


def test_forest_width_survives_save_load(tmp_path, trained):
    _, hom = trained
    path = str(tmp_path / "i.npz")
    hom.i_model.save(path)
    back = GBDTRegressor.load(path, device="cpu")
    assert back.n_features_ == 17
    x, _ = generate_i_traces(TraceConfig(n_samples=50, seed=9))
    np.testing.assert_allclose(back.predict(x), hom.i_model.predict(x),
                               rtol=1e-15)


def test_cluster_gbdt_rejects_homogeneous_forest(trained):
    _, hom = trained
    with pytest.raises(ValueError, match="hetero"):
        ClusterGBDTEstimator(hom, mixed_fast_slow(4))


def test_cluster_gbdt_scalar_batch_row_parity(trained):
    het, _ = trained
    cl = mixed_fast_slow(4)
    ce = ClusterGBDTEstimator(het, cl)
    tb = cl.compat_testbed()
    layer = LayerSpec("c", ConvT.CONV, 28, 28, 16, 32, 3, 1, 1)
    rows = [i_features(layer, s, tb, 0) for s in
            (Scheme.INH, Scheme.OUTC, Scheme.GRID2D)]
    batch = ce.i_cost_batch(np.asarray(rows, np.float64), tb)
    for row_s, got in zip((Scheme.INH, Scheme.OUTC, Scheme.GRID2D), batch):
        assert ce.i_cost(layer, row_s, tb) == pytest.approx(float(got),
                                                            rel=1e-12)
    with pytest.raises(ValueError, match="testbed"):
        ce.i_cost(layer, Scheme.INH, TorchTestbed(nodes=3))


def test_cluster_gbdt_calibration_scales_match_the_reference(ref_trained):
    """A calibrator's factors multiply the learned costs as in the
    reference (the scalar and batched paths both)."""
    jc, tc = clusters("mixed_fast_slow", 4)
    jcal, tcal = jcl.OnlineCalibrator(jc), tcl.OnlineCalibrator(tc)
    for cal in (jcal, tcal):
        cal.compute_scale = np.array([1.0, 1.7, 1.2, 0.9])
        cal.sync_scale = 1.3
    het = ref_trained[0]
    jce = jcl.ClusterGBDTEstimator(het, jc, calibration=jcal)
    tce = ClusterGBDTEstimator(
        GBDTEstimator(_carry(het.i_model), _carry(het.s_model)), tc,
        calibration=tcal)
    x, _ = generate_i_traces(TraceConfig(n_samples=80, seed=2))
    xs = np.random.default_rng(0).uniform(0, 64, size=(80, 20))
    assert np.array_equal(tce.i_cost_batch(x, tc.compat_testbed()),
                          jce.i_cost_batch(x, jc.compat_testbed()))
    assert np.array_equal(tce.s_cost_batch(xs, tc.compat_testbed()),
                          jce.s_cost_batch(xs, jc.compat_testbed()))
    layer = LayerSpec("c", ConvT.CONV, 28, 28, 16, 32, 3, 1, 1)
    from repro.core.graph import ConvT as JConvT, LayerSpec as JLayerSpec
    from repro.core.partition import Scheme as JScheme
    jlayer = JLayerSpec("c", JConvT.CONV, 28, 28, 16, 32, 3, 1, 1)
    assert tce.i_cost(layer, Scheme.OUTC, tc.compat_testbed()) == \
        jce.i_cost(jlayer, JScheme.OUTC, jc.compat_testbed())
    assert tce.s_cost(layer, None, Scheme.INH, None, tc.compat_testbed()) \
        == jce.s_cost(jlayer, None, JScheme.INH, None, jc.compat_testbed())


def test_hetero_beats_homogeneous_plan_quality(trained):
    """On mixed_fast_slow and stepped, the plan the hetero-trained GBDT
    picks (priced by the analytic cluster oracle) must strictly beat the
    plan the homogeneous-trained GBDT picks."""
    het, hom = trained
    g = resnet18(96)
    for preset in (mixed_fast_slow, stepped):
        cl = preset(6)
        tb = cl.compat_testbed()
        oracle = cluster_plan_search(g, cl)
        ae = ClusterAnalyticEstimator(cl)
        ce = ClusterGBDTEstimator(het, cl)
        het_cost = plan_cost(
            g, cluster_plan_search(g, cl, estimator=ce).plan, ae, tb)
        hom_cost = plan_cost(g, plan_search(g, hom, tb).plan, ae, tb)
        assert het_cost < hom_cost, preset.__name__
        assert het_cost < 1.5 * oracle.cost, preset.__name__


def test_gbdt_scalar_caches_are_bounded(trained):
    _, hom = trained
    est = GBDTEstimator(hom.i_model, hom.s_model, cache_size=32)
    cl = mixed_fast_slow(4)
    tb = cl.compat_testbed()
    for c in range(3, 100):
        layer = LayerSpec(f"c{c}", ConvT.POINTWISE, 14, 14, c, 2 * c,
                          1, 1, 0)
        est.i_cost(layer, Scheme.OUTC, tb)
        est.s_cost(layer, None, Scheme.OUTC, None, tb)
    assert len(est._i_cache) <= 32 and len(est._s_cache) <= 32
    hits, misses = est.cache_info()
    assert misses == 2 * 97 and hits == 0
    layer = LayerSpec("c99", ConvT.POINTWISE, 14, 14, 99, 198, 1, 1, 0)
    est.i_cost(layer, Scheme.OUTC, tb)
    assert est.cache_info() == (1, 2 * 97)
    est.clear_cache()
    assert len(est._i_cache) == 0
    with pytest.raises(ValueError):
        GBDTEstimator(hom.i_model, hom.s_model, cache_size=0)


# ---------------------------------------------------------------------------
# carried-over forests plan as in the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nodes", [3, 4])
@pytest.mark.parametrize("name", ["mobilenet", "resnet18", "bert"])
def test_plan_search_on_carried_forests_equals_the_reference(
        ref_trained, name, nodes):
    hom = ref_trained[1]
    gj, gt = graphs(name, "test")
    est = GBDTEstimator(_carry(hom.i_model), _carry(hom.s_model))
    for bw in (0.5, 5.0):
        res = plan_search(gt, est,
                          TorchTestbed(nodes=nodes, bandwidth_gbps=bw))
        ref = j_plan_search(gj, hom,
                            JTestbed(nodes=nodes, bandwidth_gbps=bw))
        assert steps(res.plan) == steps(ref.plan)
        assert res.cost == ref.cost
        assert res.stats == type(res.stats)(**vars(ref.stats))


@pytest.mark.parametrize("preset", ["mixed_fast_slow", "stepped"])
@pytest.mark.parametrize("name", ["mobilenet", "resnet18", "bert"])
def test_cluster_plan_search_on_carried_forests_equals_the_reference(
        ref_trained, name, preset):
    het = ref_trained[0]
    gj, gt = graphs(name, "test")
    jc, tc = clusters(preset, 6)
    tce = ClusterGBDTEstimator(
        GBDTEstimator(_carry(het.i_model), _carry(het.s_model)), tc)
    res = cluster_plan_search(gt, tc, estimator=tce)
    ref = jcl.cluster_plan_search(gj, jc, estimator=jcl.ClusterGBDTEstimator(
        het, jc))
    assert steps(res.plan) == steps(ref.plan)
    assert res.cost == ref.cost


def test_scalar_gbdt_search_on_carried_forests_equals_the_reference(
        ref_trained):
    """``plan_search_reference`` drives the forests one row at a time
    through the LRU-cached scalar path; it lands on the batched search's
    plan and cost, and on the reference's."""
    hom = ref_trained[1]
    gj, gt = graphs("mobilenet", "test")
    est = GBDTEstimator(_carry(hom.i_model), _carry(hom.s_model))
    jest = JGBDTEstimator(hom.i_model, hom.s_model)
    tb, jtb = TorchTestbed(nodes=4), JTestbed(nodes=4)
    res = plan_search_reference(gt, est, tb)
    ref = j_plan_search_reference(gj, jest, jtb)
    assert steps(res.plan) == steps(ref.plan) and res.cost == ref.cost
    assert res.stats == type(res.stats)(**vars(ref.stats))
    assert est.cache_info() == jest.cache_info()
    batched = plan_search(gt, est, tb)
    assert steps(batched.plan) == steps(res.plan)
    assert batched.cost == res.cost


def test_device_forests_load_from_the_reference_npz(tmp_path, ref_trained):
    """The npz route into an estimator: ``load`` of the reference's file
    prices exactly as the reference does."""
    hom = ref_trained[1]
    pi, ps = str(tmp_path / "i.npz"), str(tmp_path / "s.npz")
    hom.i_model.save(pi)
    hom.s_model.save(ps)
    est = GBDTEstimator(GBDTRegressor.load(pi, device="cpu"),
                        GBDTRegressor.load(ps, device="cpu"))
    x, _ = generate_i_traces(TraceConfig(n_samples=300, seed=8))
    assert np.array_equal(est.i_cost_batch(x, TorchTestbed()),
                          hom.i_cost_batch(x, JTestbed()))
    assert isinstance(JGBDT.load(pi), JGBDT)
