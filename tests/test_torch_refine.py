"""The port's refinement loop (``cluster.refine.refine_with_simulator``)
and its calibrator (``cluster.calibrate.OnlineCalibrator``) against the
JAX package's, and the loop over the port's own mesh executor.

The loop runs once on the simulator and once on scripted occupancy
sequences — constant, drifting, flipping (an oscillation) and failed
samples, as ``tests/test_elastic.py`` and
``tests/test_hetero_estimator.py`` script them — fed identically to both
packages.  Each must give the same ``RefineResult`` (steps, convergence,
the plan by enum value, the best throughput and the simulator's report),
the same ``RefineOscillationError`` under ``on_oscillation="raise"``, and
calibrator scales bit-equal after every ``observe``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.cluster as jcl
import repro.cluster.refine as j_refine_mod

import repro_torch.cluster as tcl
import repro_torch.cluster.refine as t_refine_mod
from repro_torch import ExecConfig, Session, init_weights
from repro_torch.runtime.engine import MeasuredOccupancy
from torch_cluster_pairs import (Occ, clusters, graphs, plain, steps,
                                 to_jplan, toy_chain)


def _refine_both(gj, gt, jc, tc, **kw):
    """Run both loops on the same arguments; ``occupancy`` (a factory of
    a fresh scripted sequence) and ``calibrate`` (a decay) are built once
    per side so each side sees its own, identical, sequence."""
    occupancy = kw.pop("occupancy", None)
    decay = kw.pop("calibrate", None)
    out = []
    for mod, g, c in ((jcl, gj, jc), (tcl, gt, tc)):
        cal = None if decay is None else mod.OnlineCalibrator(c, decay=decay)
        extra = dict(kw)
        if occupancy is not None:
            extra["occupancy_fn"] = occupancy()
        res = mod.refine_with_simulator(g, c, calibrator=cal, **extra)
        out.append((res, cal))
    return out


def _check_same(pair):
    (rj, cj), (rt, ct) = pair
    assert plain(rt) == plain(rj)
    assert steps(rt.plan) == steps(rj.plan)
    assert rt.converged == rj.converged
    assert rt.best_throughput_rps == rj.best_throughput_rps
    assert rt.throughput_rps == rj.throughput_rps
    if cj is not None:
        assert np.array_equal(ct.compute_scale, cj.compute_scale)
        assert ct.sync_scale == cj.sync_scale
        assert plain(ct.history) == plain(cj.history)
        assert ct.axis_scales() == cj.axis_scales()
    return rt


# ---------------------------------------------------------------------------
# On the simulator
# ---------------------------------------------------------------------------

SIM_GRID = (("mobilenet", "full", ("uniform", 4)),
            ("mobilenet", "full", ("stepped", 4)),
            ("resnet18", "full", ("mixed_fast_slow", 6)),
            ("resnet18", "full", ("asym_uplink", 4)),
            ("bert", "full", ("uniform", 2)),
            ("inception", "full", ("stepped", 4)),
            ("resnet101", "test", ("mixed_fast_slow", 4)))


@pytest.mark.parametrize("name,scale,cluster", SIM_GRID,
                         ids=[f"{m}-{s}-{c[0]}{c[1]}" for m, s, c in SIM_GRID])
def test_refine_on_the_simulator_matches(name, scale, cluster):
    gj, gt = graphs(name, scale)
    jc, tc = clusters(*cluster)
    _check_same(_refine_both(gj, gt, jc, tc, n_requests=12, max_iters=4))
    _check_same(_refine_both(gj, gt, jc, tc, n_requests=8, max_iters=3,
                             calibrate=0.5, weighted=False))


def test_refine_on_the_simulator_with_rel_tol_and_a_shared_frontier():
    gj, gt = graphs("mobilenet", "test")
    jc, tc = clusters("mixed_fast_slow", 4)
    fj = jcl.cluster_pipeline_frontier(gj, jc, prune_ub=True)
    ft = tcl.cluster_pipeline_frontier(gt, tc, prune_ub=True)
    rj = jcl.refine_with_simulator(gj, jc, n_requests=6, frontier=fj,
                                   rel_tol=0.5)
    rt = tcl.refine_with_simulator(gt, tc, n_requests=6, frontier=ft,
                                   rel_tol=0.5)
    assert plain(rt) == plain(rj)


@pytest.mark.parametrize("rps", [0.0, float("inf")], ids=["zero", "inf"])
def test_degenerate_simulator_reports_are_untrusted_alike(monkeypatch, rps):
    """A zero- or infinite-throughput report is an untrusted sample on
    both sides: never certified, the period recorded as 0."""
    for mod in (j_refine_mod, t_refine_mod):
        real = mod.simulate

        def degenerate(graph, plan, cluster, real=real, **kw):
            rep = real(graph, plan, cluster, **kw)
            return dataclasses.replace(rep, throughput_rps=rps)

        monkeypatch.setattr(mod, "simulate", degenerate)
    gj, gt = graphs("mobilenet", "test")
    jc, tc = clusters("mixed_fast_slow", 4)
    rt = _check_same(_refine_both(gj, gt, jc, tc, n_requests=4, max_iters=3,
                                  rel_tol=0.5))
    assert not rt.converged
    assert all(s.sim_period_s == 0.0 for s in rt.steps)


# ---------------------------------------------------------------------------
# On scripted occupancy sequences
# ---------------------------------------------------------------------------

def constant():
    return lambda plan: Occ(2e-3, 1e-3)


def drifting():
    calls = {"n": 0}

    def fn(plan):
        calls["n"] += 1
        return Occ(0.5 + 1e-6 * calls["n"], 0.2)   # ~ppm wobble
    return fn


def flipping():
    calls = {"n": 0}

    def fn(plan):
        # alternately blame compute then sync: the re-weighted selection
        # ping-pongs between the frontier's two ends
        calls["n"] += 1
        return Occ(10.0, 1e-3) if calls["n"] % 2 else Occ(1e-3, 10.0)
    return fn


def failing():
    return lambda plan: Occ(0.5, 0.2, failures=2)


def fail_then_recover():
    calls = {"n": 0}

    def fn(plan):
        calls["n"] += 1
        if calls["n"] == 1:
            return Occ(5.0, 1e-4, failures=1)
        return Occ(1e-3 * calls["n"], 2e-3, period=3e-3)
    return fn


def from_plan():
    """Occupancy that depends on the plan (its OutC share), so each
    selection sees different ratios."""
    def fn(plan):
        outc = sum(1 for s, _ in plan.steps if int(s) == 2)
        return Occ(1e-3 * (1 + outc), 4e-3 / (1 + outc))
    return fn


SCRIPTS = {"constant": constant, "drifting": drifting, "flipping": flipping,
           "failing": failing, "fail_then_recover": fail_then_recover,
           "from_plan": from_plan}
KNOBS = (dict(max_iters=6), dict(max_iters=5, rel_tol=1e-3),
         dict(max_iters=6, calibrate=1.0), dict(max_iters=4, calibrate=0.5))


@pytest.mark.parametrize("knobs", KNOBS, ids=["plain", "rel_tol", "cal1",
                                              "cal05"])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_refine_on_scripted_occupancy_matches(script, knobs):
    results = []
    for (gj, gt), cluster in ((toy_chain(), ("stepped", 4)),
                              (graphs("mobilenet", "test"), ("uniform", 2))):
        jc, tc = clusters(*cluster)
        rt = _check_same(_refine_both(gj, gt, jc, tc, occupancy=SCRIPTS[
            script], **knobs))
        assert rt.report is None
        results.append(rt)
    toy = results[0]      # the reference tests' expectations on the toy
    if script == "failing":
        # the untrusted sample repeats the same point, never certified,
        # and keeps the starting weights
        assert len(toy.steps) == 1 and not toy.converged
    if script == "drifting" and "rel_tol" in knobs:
        assert toy.converged and len(toy.steps) == 2
    if script == "constant":
        assert toy.converged


def test_oscillation_raises_alike():
    gj, gt = toy_chain()
    jc, tc = clusters("stepped", 4)
    msgs = []
    for mod, g, c, err in ((jcl, gj, jc, jcl.RefineOscillationError),
                           (tcl, gt, tc, tcl.RefineOscillationError)):
        with pytest.raises(err) as e:
            mod.refine_with_simulator(g, c, occupancy_fn=flipping(),
                                      on_oscillation="raise", max_iters=6)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    r = tcl.refine_with_simulator(gt, tc, occupancy_fn=flipping(),
                                  max_iters=6)
    assert not r.converged and len(r.steps) >= 2
    with pytest.raises(ValueError):
        tcl.refine_with_simulator(gt, tc, on_oscillation="bogus")
    with pytest.raises(ValueError):
        tcl.refine_with_simulator(gt, tc, rel_tol=-0.1)


# ---------------------------------------------------------------------------
# The calibrator alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decay", [1.0, 0.5, 0.2])
def test_calibrator_matches_after_every_observe(decay):
    for name, cluster in (("mobilenet", ("stepped", 4)),
                          ("resnet18", ("mixed_fast_slow", 6)),
                          ("bert", ("asym_uplink", 4))):
        gj, gt = graphs(name, "test")
        jc, tc = clusters(*cluster)
        cj = jcl.OnlineCalibrator(jc, decay=decay)
        ct = tcl.OnlineCalibrator(tc, decay=decay)
        fr = tcl.cluster_pipeline_frontier(gt, tc, prune_ub=False)
        idx = sorted({0, len(fr) // 2, len(fr) - 1})
        samples = []
        for i in idx:
            pt = fr.plan(i)
            samples += [
                (pt, "sim", dict(n_requests=6)),
                (pt, "sim", dict(n_requests=5, arrival_period_s=1e-3)),
                (pt, Occ(3e-3, 2e-3), {}),
                (pt, Occ(1e-2, 5e-3, failures=1), {}),
                (pt, MeasuredOccupancy(4e-3, 1e-3, 4e-3, 5e-3), {}),
            ]
        for pt, m, kw in samples:
            pj = to_jplan(pt)
            for batch in (1, 2):
                got = ct.predicted_occupancy(gt, pt, batch_size=batch)
                want = cj.predicted_occupancy(gj, pj, batch_size=batch)
                assert all(np.array_equal(a, b) for a, b in zip(got, want))
                assert ct.predict_period(gt, pt, batch_size=batch) == \
                    cj.predict_period(gj, pj, batch_size=batch)
            if m == "sim":
                mt = tcl.simulate(gt, pt, tc, **kw)
                mj = jcl.simulate(gj, pj, jc, **kw)
            else:
                mt = mj = m
            assert ct.observe(gt, pt, mt) == cj.observe(gj, pj, mj)
            assert np.array_equal(ct.compute_scale, cj.compute_scale)
            assert ct.sync_scale == cj.sync_scale
            assert ct.axis_scales() == cj.axis_scales()
        assert plain(ct.history) == plain(cj.history)
        assert not ct.history[3].trusted
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError):
            tcl.OnlineCalibrator(tc, decay=bad)


def test_simulator_report_folds_to_near_identity():
    gt = graphs("mobilenet", "test")[1]
    cl = tcl.stepped(4)
    plan = tcl.cluster_plan_search(gt, cl).plan
    cal = tcl.OnlineCalibrator(cl, decay=1.0)
    cal.observe(gt, plan, tcl.simulate(gt, plan, cl, n_requests=8))
    np.testing.assert_allclose(cal.compute_scale, 1.0, rtol=1e-6)
    assert cal.sync_scale == pytest.approx(1.0, rel=1e-6)


# ---------------------------------------------------------------------------
# The port's own loop: occupancy measured by its mesh executor
# ---------------------------------------------------------------------------

def test_refine_on_the_ports_mesh_occupancy():
    """``occupancy_fn`` runs each candidate plan on the port's mesh
    executor (CPU tensors, ``instrument=True``, ``overlap=False``): the
    loop runs on measured numbers, ``report`` is None, every step's
    measured compute is positive, and every run is fault-free and equal
    to the local executor's output."""
    gt = graphs("mobilenet", "test")[1]
    cl = tcl.homogeneous(2, bandwidth_gbps=1.0)
    w = init_weights(gt, torch.Generator().manual_seed(0), "cpu")
    l0 = gt.layers[0]
    x = torch.randn((l0.in_h, l0.in_w, l0.in_c),
                    generator=torch.Generator().manual_seed(1))
    tried = []

    def measure(plan):
        sess = Session(gt, w, plan, cl.n, ExecConfig(
            executor="mesh", overlap=False, instrument=True, device="cpu"))
        out, st = sess.run(x)
        local, st_l = Session(gt, w, plan, cl.n,
                              ExecConfig(device="cpu")).run(x)
        assert st == st_l and st.failure_count == 0
        assert torch.allclose(out, local, rtol=0, atol=1e-4 * max(
            1.0, float(local.abs().max())))
        v = tcl.build_stages(gt, plan, cl)
        assert len([s for s in st.stage_times if s.kind == "compute"]) == \
            len([s for s in v if s.kind == "compute"])
        tried.append(plan)
        return st.to_occupancy()

    cal = tcl.OnlineCalibrator(cl)
    rr = tcl.refine_with_simulator(gt, cl, max_iters=2, occupancy_fn=measure,
                                   calibrator=cal)
    assert tried and rr.report is None
    assert rr.steps and rr.throughput_rps > 0.0
    assert all(s.dev_occupancy_s > 0.0 for s in rr.steps)
    assert len(cal.history) == len(rr.steps)
    assert all(h.trusted for h in cal.history)
