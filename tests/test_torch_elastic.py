"""The port's elastic planner (``repro_torch.cluster.elastic``) against the
JAX package's, in one process.

* Every case of the reference's ``tests/test_elastic.py`` (18) runs on the
  port: its source executed again with ``repro`` imports redirected to
  ``repro_torch`` (``torch_ref_cases``).
* The same calls on both packages give equal results: registry
  transitions, versions, signatures and projected clusters;
  ``plan_device_bytes``, ``plan_memory_ok`` and ``migration_cost_s`` bit
  for bit; ``ReplanDecision`` field for field (plans by enum value,
  periods, scores, migrations, reuse dicts, keep or migrate, the frontier),
  with the planner's wall clock shared between the packages by a fake
  clock; and the replan spans, metrics and flight records.
"""
import dataclasses
import itertools
import types

import numpy as np
import pytest

import repro.cluster as jcl
import repro.cluster.elastic as jel
import repro.obs as jobs
import repro_torch.cluster as tcl
import repro_torch.cluster.elastic as tel
import repro_torch.obs as tobs
from repro.core.partition import Mode as JMode
from repro.core.partition import Scheme as JScheme
from repro.core.plan import Plan as JPlan
from repro_torch.core.partition import Mode, Scheme
from repro_torch.core.plan import Plan
from torch_cluster_pairs import graphs, plain, steps, toy_chain, toy_dag
from torch_ref_cases import port_namespace, reference_cases, run_case

PORT = port_namespace("test_elastic")
CASES = reference_cases(PORT)


def test_the_reference_module_runs_on_the_port():
    assert len(CASES) == 18
    assert PORT["ElasticPlanner"] is tcl.ElasticPlanner
    assert PORT["DTYPE_BYTES"] == jel.DTYPE_BYTES


@pytest.mark.parametrize("name", CASES)
def test_reference_case_holds_on_the_port(name, request):
    run_case(PORT, name, request)


# ---------------------------------------------------------------------------
# the same calls on both packages
# ---------------------------------------------------------------------------

SIDES = (("ref", jcl), ("port", tcl))


def named(cl_mod, cluster):
    """``cluster`` with unique device names (the registry's key)."""
    return dataclasses.replace(cluster, devices=tuple(
        dataclasses.replace(d, name=f"d{i}")
        for i, d in enumerate(cluster.devices)))


def _registry_script(cl):
    """Registry transitions under a fixed script, recorded after each
    step: the state change (or the error raised), version, live set,
    signature and the projected cluster (and whether it is the seed)."""
    out = []

    def rec(what, fn):
        try:
            res = fn()
        except (cl.MembershipError, ValueError) as exc:
            res = type(exc).__name__
        try:
            proj = reg.cluster()
            proj_v = (plain(proj), proj is seed)
        except cl.MembershipError:
            proj_v = "empty"
        out.append((what, plain(res), reg.version,
                    [m.spec.name for m in reg.live_members()],
                    [(m.spec.name, m.state.value, m.misses, m.derate)
                     for m in reg.members()],
                    plain(reg.signature()), proj_v))

    seed = named(cl, cl.asym_uplink(4))
    reg = cl.DeviceRegistry.from_cluster(seed, heartbeat_interval_s=1.0,
                                         suspect_misses=2, dead_misses=4)
    rec("seed", lambda: None)
    rec("derate", lambda: reg.report_derate("d1", 0.5, now=1.0))
    rec("bad derate", lambda: reg.report_derate("d1", 0.0, now=1.0))
    rec("link", lambda: reg.set_link_factor(0.25))
    rec("bad link", lambda: reg.set_link_factor(-1.0))
    for t in (1.5, 2.5):
        for name in ("d0", "d1", "d2"):
            rec(f"hb {name}@{t}", lambda n=name, t=t: reg.heartbeat(
                n, now=t, derate=0.5 if n == "d1" else None))
    rec("tick 2.5", lambda: reg.tick(now=2.5))
    rec("tick 4.5", lambda: reg.tick(now=4.5))
    rec("hb dead", lambda: reg.heartbeat("d3", now=4.6))
    rec("rejoin", lambda: reg.join(seed.devices[3], now=4.7))
    rec("hb rejoined", lambda: reg.heartbeat("d3", now=4.7))
    rec("double join", lambda: reg.join(seed.devices[0], now=4.8))
    rec("clear derate", lambda: reg.report_derate("d1", 1.0, now=5.0))
    rec("clear link", lambda: reg.set_link_factor(1.0))
    rec("leave", lambda: reg.leave("d2", now=5.5))
    rec("unknown", lambda: reg.heartbeat("ghost", now=6.0))
    rec("new", lambda: reg.join(cl.DeviceSpec(name="x0", gflops=12.0),
                                now=6.0))
    rec("hb new", lambda: reg.heartbeat("x0", now=6.1))
    rec("tick 9", lambda: reg.tick(now=9.0))
    for name in ("d0", "d1", "d3", "x0"):
        rec(f"leave {name}", lambda n=name: reg.leave(n, now=9.5))
    return out


def test_registry_transitions_and_projections_equal():
    got = {side: _registry_script(cl) for side, cl in SIDES}
    assert got["port"] == got["ref"]
    assert got["ref"][0][-1][1] is True          # the seed's own spec
    assert got["ref"][-1][-1] == "empty"


#: (reference plan, port plan) builders of a graph pair
def _fixed(scheme):
    def build(gj, gt):
        return (JPlan(tuple((JScheme(int(scheme)), JMode.T)
                            for _ in gj.layers)),
                Plan(tuple((scheme, Mode.T) for _ in gt.layers)))
    return build


def _searched(gj, gt, cj, ct):
    pj = jcl.cluster_plan_search(gj, cj, objective=jcl.Objective.THROUGHPUT)
    pt = tcl.cluster_plan_search(gt, ct, objective=tcl.Objective.THROUGHPUT)
    assert steps(pt.plan) == steps(pj.plan)
    return pj.plan, pt.plan


GRAPHS = {"toy": toy_chain, "rb": toy_dag,
          "mobilenet": lambda: graphs("mobilenet", "small"),
          "resnet18": lambda: graphs("resnet18", "small"),
          "bert": lambda: graphs("bert", "small")}


def _clusters(cl):
    st4 = cl.stepped(4)
    mf4 = cl.mixed_fast_slow(4)
    shrunk = dataclasses.replace(st4, devices=st4.devices[:-1],
                                 links=st4.links[:3])
    derated = dataclasses.replace(mf4, devices=tuple(
        dataclasses.replace(d, eff_derate=0.6) if i == 1 else d
        for i, d in enumerate(mf4.devices)))
    return {"stepped4": st4, "mixed4": mf4, "stepped3": shrunk,
            "mixed4-derated": derated, "asym4": named(cl, cl.asym_uplink(4))}


@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_plan_bytes_and_migration_costs_bit_equal(gname):
    gj, gt = GRAPHS[gname]()
    cjs, cts = _clusters(jcl), _clusters(tcl)
    plans = {}
    for scheme in (Scheme.INH, Scheme.INW, Scheme.OUTC, Scheme.GRID2D):
        plans[scheme.name] = _fixed(scheme)(gj, gt)
    plans["searched"] = _searched(gj, gt, cjs["mixed4"], cts["mixed4"])
    for cname in cjs:
        cj, ct = cjs[cname], cts[cname]
        for pname, (pj, pt) in plans.items():
            bj = jel.plan_device_bytes(gj, pj, cj)
            bt = tel.plan_device_bytes(gt, pt, ct)
            assert bt.dtype == bj.dtype and np.array_equal(bt, bj), \
                (cname, pname)
            assert tel.plan_memory_ok(gt, pt, ct) == \
                jel.plan_memory_ok(gj, pj, cj)
    pairs = [(None, "stepped4"), ("stepped4", "stepped4"),
             ("stepped4", "stepped3"), ("mixed4", "mixed4-derated"),
             ("stepped4", "mixed4"), ("asym4", "stepped3")]
    for (old_c, new_c), (po, pn), (inflight, period) in itertools.product(
            pairs, itertools.product(plans, repeat=2),
            ((0, 0.0), (4, 0.0123), (7, 1e-3))):
        old_j = None if old_c is None else cjs[old_c]
        old_t = None if old_c is None else cts[old_c]
        mj = jel.migration_cost_s(
            gj, None if old_c is None else plans[po][0], old_j,
            plans[pn][0], cjs[new_c], inflight=inflight,
            old_period_s=period)
        mt = tel.migration_cost_s(
            gt, None if old_c is None else plans[po][1], old_t,
            plans[pn][1], cts[new_c], inflight=inflight,
            old_period_s=period)
        assert plain(mt) == plain(mj), (old_c, new_c, po, pn)
        assert mt.total_s == mj.total_s


@pytest.fixture
def shared_clock(monkeypatch):
    """One deterministic wall clock (a step of 0.25 ms a call), a copy for
    each package's ``cluster.elastic``: ``plan_wall_s`` then compares."""
    for m in (jel, tel):
        ticks = itertools.count()
        monkeypatch.setattr(m, "time", types.SimpleNamespace(
            perf_counter=lambda t=ticks: 10.0 + 2.5e-4 * next(t)))


def _replan_script(cl, g, preset):
    """An ElasticPlanner over a registry through cold start, a uniform
    derate (the rescale path), one device's derate, a link slowdown, a
    revert (the frontier cache), a crash (shrink), a rejoin, and the
    keep-versus-migrate variants; every decision recorded."""
    base = cl.CLUSTER_PRESETS[preset](4)
    reg = cl.DeviceRegistry.from_cluster(base, heartbeat_interval_s=1.0,
                                         dead_misses=2)
    names = [d.name for d in base.devices]
    pl = cl.ElasticPlanner(g, horizon_requests=400.0, inflight=3,
                           cache_size=4)
    out = []
    old = None

    def step(what, **kw):
        nonlocal old
        cur = reg.cluster()
        if old is None:
            dec = pl.replan(cur, **kw)
        else:
            dec = pl.replan(cur, old[0], old[1], old_period_s=old[2], **kw)
        out.append((what, plain(dec), cur.n))
        old = (dec.plan, cur, dec.period_s)

    step("cold")
    for n in names:
        reg.report_derate(n, 0.5, now=1.0)
    step("uniform derate")
    reg.report_derate(names[0], 0.8, now=1.5)
    step("one derate")
    step("one derate, no keep", consider_keep=False)
    reg.set_link_factor(0.5)
    step("slowdown")
    reg.set_link_factor(1.0)
    for n in names:
        reg.report_derate(n, 1.0, now=2.0)
    step("revert")
    for n in names[:-1]:
        reg.heartbeat(n, now=4.0)
    reg.tick(now=4.0)
    step("crash")
    step("crash, latency", objective=cl.Objective.LATENCY)
    reg.join(base.devices[-1], now=5.0)
    reg.heartbeat(names[-1], now=5.0)
    step("rejoin")
    # the frontier's best plan again, nothing in flight: keep and migrate
    # score the same, and a tie keeps
    tie = cl.ElasticPlanner(g, inflight=0)
    best = tie.replan(reg.cluster())
    dt = tie.replan(reg.cluster(), best.plan, reg.cluster())
    out.append(("tie", plain(dt), reg.cluster().n))
    short = cl.ElasticPlanner(g, horizon_requests=1e-6)
    reg.report_derate(names[1], 0.95, now=6.0)
    dk = short.replan(reg.cluster(), old[0], old[1], old_period_s=old[2])
    out.append(("short horizon", plain(dk), reg.cluster().n))
    return out, pl.replans


@pytest.mark.parametrize("gname,preset", [
    ("toy", "stepped"), ("toy", "mixed_fast_slow"), ("rb", "stepped"),
    ("mobilenet", "mixed_fast_slow"), ("resnet18", "stepped")])
def test_replan_decisions_equal(gname, preset, shared_clock):
    gj, gt = GRAPHS[gname]()
    got = {}
    for side, cl, obs, g in (("ref", jcl, jobs, gj), ("port", tcl, tobs, gt)):
        tr = obs.set_tracer(obs.Tracer())
        mx = obs.set_metrics(obs.Metrics())
        obs.get_flight().clear()
        try:
            decisions = _replan_script(cl, g, preset)
        finally:
            obs.set_tracer(None)
            obs.set_metrics(None)
        got[side] = dict(
            decisions=decisions, metrics=mx.snapshot(),
            spans=[(s["name"], s["cat"], s["track"], s["depth"], s["args"])
                   for s in tr.spans()],
            flight=[{k: v for k, v in e.items() if k != "t_us"}
                    for e in obs.get_flight().events()])
        obs.get_flight().clear()
    assert got["port"]["decisions"] == got["ref"]["decisions"]
    assert got["port"]["metrics"] == got["ref"]["metrics"]
    assert got["port"]["spans"] == got["ref"]["spans"]
    assert got["port"]["flight"] == got["ref"]["flight"]
    # the script reaches the reuse paths it is written for
    reuse = {what: d["reuse"] for what, d, _ in got["ref"]["decisions"][0]}
    assert reuse["revert"]["frontier_cache"]
    assert reuse["one derate"]["registration"]
    assert reuse["one derate"]["svals"]
    if gj.is_chain:
        # on a DAG the frontier's period and the plan's re-costed one may
        # differ in the last bit (another order of sums): no exact tie
        tie = [d for what, d, _ in got["ref"]["decisions"][0]
               if what == "tie"]
        assert tie[0]["keep_score_s"] == tie[0]["score_s"]
        assert tie[0]["point_idx"] is None
    names = [s[0] for s in got["ref"]["spans"]]
    assert {"replan.frontier", "replan.select", "replan.cutover"} <= \
        set(names)


def test_capacity_error_in_both():
    gj, gt = toy_chain()
    for cl, g in ((jcl, gj), (tcl, gt)):
        c = cl.stepped(3)
        tiny = dataclasses.replace(c, devices=tuple(
            dataclasses.replace(d, mem_mb=0.001) for d in c.devices))
        with pytest.raises(cl.CapacityError):
            cl.ElasticPlanner(g).replan(tiny)
    loose = [plain(cl.ElasticPlanner(g, enforce_memory=False).replan(
        dataclasses.replace(cl.stepped(3), devices=tuple(
            dataclasses.replace(d, mem_mb=0.001)
            for d in cl.stepped(3).devices))).plan)
        for cl, g in ((jcl, gj), (tcl, gt))]
    assert loose[0] == loose[1]
