"""The port's trace generator (``repro_torch.sim.trace``) against the JAX
package's ``repro.sim.trace``.

Sampling is numpy in both, so the same config draws the same stream; the
labels come from each package's own batched physics.  ``X`` and ``y``
must be equal to the bit for the homogeneous default stream and for the
heterogeneous configs, over several seeds; then the reference's own
trace tests (``tests/test_hetero_estimator.py``) run against the port.
"""
import numpy as np
import pytest

from repro.sim import trace as jtrace

from repro_torch.cluster import (ClusterAnalyticEstimator, mixed_fast_slow,
                                 stepped)
from repro_torch.core import N_HETERO_FEATURES
from repro_torch.sim import trace as ttrace
from repro_torch.sim import (HETERO_PRESETS, TraceConfig, generate_i_traces,
                             generate_s_traces, hetero_trace_config)

CONFIGS = {
    "default": lambda m, s: m.TraceConfig(n_samples=2000, seed=s),
    "hetero": lambda m, s: m.hetero_trace_config(n_samples=2000, seed=s),
    "hetero-0.7": lambda m, s: m.hetero_trace_config(
        n_samples=2000, seed=s, hetero_fraction=0.7),
    "one-preset": lambda m, s: m.TraceConfig(
        n_samples=2000, seed=s, noise_sigma=0.0, node_choices=(4, 6),
        cluster_presets=("asym_uplink",), hetero_fraction=1.0),
}


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("kind", ["i", "s"])
def test_trace_stream_bit_equals_the_reference(kind, config, seed):
    cj = CONFIGS[config](jtrace, seed)
    ct = CONFIGS[config](ttrace, seed)
    gen_j = jtrace.generate_i_traces if kind == "i" else \
        jtrace.generate_s_traces
    gen_t = generate_i_traces if kind == "i" else generate_s_traces
    xj, yj = gen_j(cj)
    xt, yt = gen_t(ct)
    assert xt.shape == xj.shape and xt.dtype == xj.dtype
    assert np.array_equal(xt, xj)
    assert np.array_equal(yt, yj)


def test_presets_match_the_reference():
    assert HETERO_PRESETS == jtrace.HETERO_PRESETS
    assert hetero_trace_config().cluster_presets == HETERO_PRESETS
    assert TraceConfig() == TraceConfig(n_samples=330_000, seed=0)


# ---------------------------------------------------------------------------
# tests/test_hetero_estimator.py's trace cases against the port
# ---------------------------------------------------------------------------

def test_default_trace_stream_unchanged_and_deterministic():
    cfg = TraceConfig(n_samples=200, seed=3)
    xa, ya = generate_i_traces(cfg)
    xb, yb = generate_i_traces(cfg)
    assert xa.shape == (200, 17)
    assert np.array_equal(xa, xb) and np.array_equal(ya, yb)
    sa, sya = generate_s_traces(cfg)
    assert sa.shape == (200, 20)
    sb, syb = generate_s_traces(cfg)
    assert np.array_equal(sa, sb) and np.array_equal(sya, syb)


def test_hetero_traces_widened_with_summary_columns():
    cfg = hetero_trace_config(n_samples=300, seed=2)
    x, _ = generate_i_traces(cfg)
    assert x.shape == (300, 17 + N_HETERO_FEATURES)
    shares = x[:, 17:20]
    assert np.all(shares[:, 0] <= shares[:, 1] + 1e-15)
    assert np.all(shares[:, 1] <= shares[:, 2] + 1e-15)
    hom = np.isclose(shares[:, 0], shares[:, 2])
    assert hom.any() and (~hom).any()
    assert np.allclose(x[hom, 17], 1.0 / x[hom, 14])
    xs, _ = generate_s_traces(cfg)
    assert xs.shape == (300, 20 + N_HETERO_FEATURES)


def test_i_trace_labels_match_hetero_batched_physics():
    """Single-preset, single-node-count, noise-free config: every label is
    exactly what ClusterAnalyticEstimator prices for that cluster."""
    cl = mixed_fast_slow(4)
    cfg = TraceConfig(n_samples=60, noise_sigma=0.0, seed=5,
                      node_choices=(4,),
                      cluster_presets=("mixed_fast_slow",),
                      hetero_fraction=1.0)
    x, y = generate_i_traces(cfg)
    expect = ClusterAnalyticEstimator(cl).i_cost_batch(
        x, cl.compat_testbed())
    np.testing.assert_allclose(np.exp(y), np.maximum(expect, 1e-9),
                               rtol=1e-12)


def test_s_trace_labels_match_projected_sync():
    cl = stepped(4)
    cfg = TraceConfig(n_samples=60, noise_sigma=0.0, seed=6,
                      node_choices=(4,), cluster_presets=("stepped",),
                      hetero_fraction=1.0)
    x, y = generate_s_traces(cfg)
    expect = ClusterAnalyticEstimator(cl).s_cost_batch(
        x, cl.compat_testbed())
    np.testing.assert_allclose(np.exp(y), np.maximum(expect, 1e-9),
                               rtol=1e-12)
