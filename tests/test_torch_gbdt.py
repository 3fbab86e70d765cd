"""The port's GBDT (``repro_torch.gbdt``) against the JAX package's
``repro.gbdt``, on CPU tensors.

The cases of ``tests/test_gbdt.py`` run against the port, then the two
packages side by side on the same seeded data:

* a forest the reference fit, carried across by its npz file and by its
  node arrays (``GBDTRegressor.from_arrays``), predicts bit-equal in the
  port (``predict`` and ``predict_reference``; one row; an empty batch);
* the port's own fit on the same data and seed gives the reference's
  forest **bit for bit** — every tree's features, thresholds, children
  and leaf values, and so every prediction.  The builder sums each node
  in numpy's order (``tree.segment_sums``: the pairwise sum within each
  8192-element buffer), and CPU ``index_put_(accumulate=True)`` sums each
  histogram bin in ``np.add.at``'s row order, so no tolerance is needed;
* the port's ``save`` round-trips into the reference's ``load``.
"""
import numpy as np
import pytest
import torch

from repro.gbdt import GBDTRegressor as JGBDT
from repro.sim.trace import (TraceConfig as JTraceConfig,
                             generate_i_traces as j_i_traces,
                             generate_s_traces as j_s_traces,
                             hetero_trace_config as j_hetero_config)

from repro_torch.gbdt import GBDTRegressor
from repro_torch.gbdt.tree import RegressionTree, segment_sums


def _toy(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, size=(n, 5))
    y = (np.sin(x[:, 0]) + 0.5 * x[:, 1] ** 2 + (x[:, 2] > 0) * x[:, 3]
         + 0.05 * rng.normal(size=n))
    return x, y


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """A CPU fit is thousands of small tensor ops.  Beside the other test
    workers, intra-op threads only contend (six processes of eight threads
    made a fit ~100x slower), so this module runs them in one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gbdt(**kw):
    return GBDTRegressor(device="cpu", **kw)


def _same_forest(a, b) -> bool:
    """Reference forest ``a`` and port forest ``b``: equal base, rate and
    flat node arrays of every tree, bit for bit."""
    if (a.base_, a.learning_rate, a.n_features_) != \
            (b.base_, b.learning_rate, b.n_features_) or \
            len(a.trees_) != len(b.trees_):
        return False
    for ta, tb in zip(a.trees_, b.trees_):
        fa, fb = ta.flat(), tb.flat()
        if not all(np.array_equal(p, q) and p.dtype == q.dtype
                   for p, q in zip(fa, fb)):
            return False
    return True


# ---------------------------------------------------------------------------
# tests/test_gbdt.py against the port
# ---------------------------------------------------------------------------

def test_gbdt_fits_nonlinear_function():
    x, y = _toy()
    xt, yt = _toy(seed=1)
    m = _gbdt(n_estimators=80, learning_rate=0.2, max_depth=5)
    m.fit(x, y)
    pred = m.predict(xt)
    ss_res = np.sum((pred - yt) ** 2)
    ss_tot = np.sum((yt - yt.mean()) ** 2)
    r2 = 1 - ss_res / ss_tot
    assert r2 > 0.9, r2


def test_gbdt_save_load_roundtrip(tmp_path):
    x, y = _toy(1000)
    m = _gbdt(n_estimators=20, max_depth=4).fit(x, y)
    p = str(tmp_path / "model.npz")
    m.save(p)
    m2 = GBDTRegressor.load(p, device="cpu")
    np.testing.assert_allclose(m.predict(x[:50]), m2.predict(x[:50]),
                               rtol=1e-12)


def test_gbdt_monotone_improvement():
    x, y = _toy(2000)
    errs = []
    for n in (5, 20, 60):
        m = _gbdt(n_estimators=n, max_depth=4, subsample=1.0).fit(x, y)
        errs.append(float(np.mean((m.predict(x) - y) ** 2)))
    assert errs[0] > errs[1] > errs[2]


def test_tree_vectorized_predict_bit_matches_reference():
    """The flat-array lockstep traversal lands in exactly the scalar
    walk's leaves on every tree of a fitted forest."""
    x, y = _toy(1500, seed=4)
    m = _gbdt(n_estimators=15, max_depth=6).fit(x, y)
    xt, _ = _toy(700, seed=5)
    for tree in m.trees_:
        got = tree.predict(torch.from_numpy(xt)).numpy()
        assert np.array_equal(got, tree.predict_reference(xt))


def test_forest_vectorized_predict_bit_matches_reference():
    x, y = _toy(1500, seed=6)
    m = _gbdt(n_estimators=25, max_depth=5).fit(x, y)
    xt, _ = _toy(400, seed=7)
    assert np.array_equal(m.predict(xt), m.predict_reference(xt))
    # single row (the scalar estimator path) and empty batch
    assert np.array_equal(m.predict(xt[:1]), m.predict_reference(xt[:1]))
    assert m.predict(xt[:0]).shape == (0,)
    # a tensor in gives a tensor on the forest's device out
    t = m.predict(torch.from_numpy(xt))
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    assert np.array_equal(t.numpy(), m.predict(xt))


def test_forest_predict_exact_after_save_load(tmp_path):
    x, y = _toy(800, seed=8)
    m = _gbdt(n_estimators=10, max_depth=4).fit(x, y)
    p = str(tmp_path / "m.npz")
    m.save(p)
    m2 = GBDTRegressor.load(p, device="cpu")
    xt, _ = _toy(300, seed=9)
    assert np.array_equal(m2.predict(xt), m2.predict_reference(xt))


def test_verbose_fit_waits_for_the_obs_port(monkeypatch, capsys):
    """Since the port of ``repro.obs``: ``fit(verbose_every=...)`` logs
    the reference's ``gbdt.fit`` lines under ``REPRO_LOG`` (on stderr)."""
    x, y = _toy(200)
    monkeypatch.setenv("REPRO_LOG", "1")
    JGBDT(n_estimators=2).fit(x, y, eval_set=(x, y), verbose_every=1)
    want = capsys.readouterr()
    _gbdt(n_estimators=2).fit(x, y, eval_set=(x, y), verbose_every=1)
    got = capsys.readouterr()
    assert got.out == want.out == ""
    assert got.err == want.err
    assert got.err.count("[gbdt.fit] tree=") == 2


# ---------------------------------------------------------------------------
# numpy's summation order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_segment_sums_equal_numpy_sum(seed):
    """Every segment's sum equals ``ndarray.sum`` of the same rows to the
    bit, across the pairwise leaf size (128) and the 8192-element buffer."""
    rng = np.random.default_rng(seed)
    counts = np.concatenate([[0, 1, 7, 8, 9, 127, 128, 129, 135, 8191,
                              8192, 8193, 16385],
                             rng.integers(0, 40000, 4)])
    rng.shuffle(counts)
    v = rng.normal(size=(int(counts.sum()), 2)) * \
        rng.uniform(1e-3, 1e3, size=(1, 2))
    got = segment_sums(torch.from_numpy(v), counts).numpy()
    starts = np.cumsum(counts) - counts
    for k, (a, c) in enumerate(zip(starts, counts)):
        for col in range(2):
            seg = np.ascontiguousarray(v[a:a + c, col])
            assert got[k, col] == seg.sum(), (c, col)
    # -0.0 sums to 0.0 as numpy's does (the sum starts from 0.0)
    z = torch.tensor([[-0.0], [-0.0]], dtype=torch.float64)
    assert str(float(segment_sums(z, [2])[0, 0])) == str(np.sum([-0.0, -0.0]))


# ---------------------------------------------------------------------------
# the reference's forests in the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_forest():
    x, y = _toy(1500, seed=10)
    return JGBDT(n_estimators=25, max_depth=6).fit(x, y)


def test_carried_forest_predicts_bit_equal(tmp_path, ref_forest):
    m = ref_forest
    p = str(tmp_path / "ref.npz")
    m.save(p)
    by_npz = GBDTRegressor.load(p, device="cpu")
    by_arrays = GBDTRegressor.from_arrays(
        m.base_, m.learning_rate, [t.flat() for t in m.trees_],
        m.n_features_, device="cpu")
    xt, _ = _toy(600, seed=11)
    want = m.predict(xt)
    assert np.array_equal(want, m.predict_reference(xt))
    for port in (by_npz, by_arrays):
        assert _same_forest(m, port)
        assert port.n_features_ == 5
        assert np.array_equal(port.predict(xt), want)
        assert np.array_equal(port.predict_reference(xt), want)
        assert np.array_equal(port.predict(xt[:1]), want[:1])
        assert port.predict(xt[:0]).shape == (0,)
        for ta, tb in zip(m.trees_, port.trees_):
            assert ta.nodes == [type(ta.nodes[0])(**vars(n))
                                for n in tb.nodes]


def test_old_npz_without_width_loads(tmp_path, ref_forest):
    """Files written before the forest recorded its width still load."""
    p = str(tmp_path / "old.npz")
    ref_forest.save(p)
    data = dict(np.load(p))
    del data["n_features"]
    np.savez_compressed(p, **data)
    port = GBDTRegressor.load(p, device="cpu")
    assert port.n_features_ is None and JGBDT.load(p).n_features_ is None
    xt, _ = _toy(100, seed=12)
    assert np.array_equal(port.predict(xt), ref_forest.predict(xt))


def test_port_save_loads_in_the_reference(tmp_path):
    x, y = _toy(1200, seed=13)
    port = _gbdt(n_estimators=12, max_depth=5).fit(x, y)
    p = str(tmp_path / "port.npz")
    port.save(p)
    back = JGBDT.load(p)
    assert _same_forest(back, port)
    xt, _ = _toy(300, seed=14)
    assert np.array_equal(back.predict(xt), port.predict(xt))
    assert set(np.load(p).files) == {"base", "lr", "n_trees", "n_features",
                                     *(f"tree_{i}" for i in range(12))}


def test_tree_nodes_setter_round_trips(ref_forest):
    tree = RegressionTree(device="cpu")
    tree.nodes = ref_forest.trees_[3].nodes
    assert all(np.array_equal(p, q) for p, q in
               zip(tree.flat(), ref_forest.trees_[3].flat()))


# ---------------------------------------------------------------------------
# the port's fit against the reference's fit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("subsample", [0.9, 1.0])
@pytest.mark.parametrize("max_depth", [4, 5, 6, 7])
def test_fit_equals_the_reference_fit(max_depth, subsample):
    x, y = _toy(2500, seed=20 + max_depth)
    kw = dict(n_estimators=12, max_depth=max_depth, subsample=subsample,
              seed=max_depth)
    ref = JGBDT(**kw).fit(x, y)
    port = _gbdt(**kw).fit(x, y)
    assert _same_forest(ref, port)
    xt, _ = _toy(500, seed=3)
    assert np.array_equal(port.predict(xt), ref.predict(xt))


@pytest.mark.parametrize("kind", ["i", "s", "hetero-i", "hetero-s"])
def test_fit_on_traces_equals_the_reference_fit(kind):
    """The estimator's own data: integer-valued, repeated and constant
    columns (few bins, ragged edges), 17-25 features."""
    cfg = (j_hetero_config(n_samples=3000, seed=4, hetero_fraction=0.7)
           if kind.startswith("hetero") else
           JTraceConfig(n_samples=3000, seed=4))
    x, y = (j_i_traces if kind.endswith("i") else j_s_traces)(cfg)
    kw = dict(n_estimators=10, max_depth=7, seed=5)
    ref = JGBDT(**kw).fit(x, y)
    port = _gbdt(**kw).fit(x, y)
    assert _same_forest(ref, port)
    assert np.array_equal(port.predict(x[:400]), ref.predict(x[:400]))


def test_fit_with_regularization_options_equals_the_reference():
    """min_child_weight, reg_lambda and n_bins other than the defaults,
    and a tree-level gamma (the sequential tie rule across features)."""
    x, y = _toy(1800, seed=30)
    kw = dict(n_estimators=8, max_depth=5, min_child_weight=7.0,
              reg_lambda=3.5, n_bins=16, seed=2)
    assert _same_forest(JGBDT(**kw).fit(x, y), _gbdt(**kw).fit(x, y))
    from repro.gbdt.tree import RegressionTree as JTree
    ref_m = JGBDT(n_bins=32)
    edges = ref_m._make_bins(x)
    binned = ref_m._bin(x, edges)
    grad = np.random.default_rng(0).normal(size=len(y))
    hess = np.ones_like(grad)
    for gamma in (0.0, 0.5, 4.0):
        jt = JTree(6, 2.0, 1.0, gamma).fit(binned, edges, grad, hess)
        tt = RegressionTree(6, 2.0, 1.0, gamma, device="cpu").fit(
            torch.from_numpy(binned.astype(np.int64)), edges,
            torch.from_numpy(grad), torch.from_numpy(hess))
        assert all(np.array_equal(p, q) for p, q in
                   zip(jt.flat(), tt.flat())), gamma
