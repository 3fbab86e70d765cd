"""The mesh executor's observability hooks on CPU tensors, the port of
``tests/test_mesh_exec.py:344-442``, and its flight ring against the JAX
package's for the same plan.

* With a tracer installed, the control-track ``cat="stage"`` spans mirror
  ``ExecStats.stage_times`` one to one (count, labels, kinds, order,
  walls), and the ``cat="device"`` spans each node's completion.
* Traced runs are bit-equal to untraced ones, ``ExecStats`` equal.
* A tripped watchdog leaves one postmortem with the failing stage's
  context and its dispatch and timeout in the ring; without a postmortem
  directory nothing is written.
* The flight ring's ``(kind, stage kind, label)`` sequence, the retry
  instants and the postmortem contexts equal the reference's on the same
  plan at one node (the reference process holds one JAX device), through
  a clean run, a transient fault, a persistent fault that degrades to the
  local executor, and an injected timeout.
* At 2 and 4 nodes the ring holds one dispatch per measured stage, in
  order, and the stages equal the reference simulator's.
"""
import json
import threading

import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro_torch.obs as tobs
from repro.cluster import homogeneous as j_homogeneous
from repro.cluster.simsched import build_stages as j_build_stages
from repro.runtime import mesh_exec as j_mesh_exec

from repro_torch import AnalyticEstimator, ExecConfig, Mode, Plan, Scheme
from repro_torch import Session, plan_search
from repro_torch import Testbed as TorchTestbed
from repro_torch.runtime import mesh_exec
from repro_torch.runtime.mesh_exec import (StageTimeoutError,
                                           run_partitioned_mesh,
                                           validate_stage_decomposition)
from torch_cluster_pairs import to_jplan
from torch_conformance import model

CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _clean_obs_globals(monkeypatch):
    monkeypatch.delenv("REPRO_POSTMORTEM_DIR", raising=False)

    def clean():
        for obs in (jobs, tobs):
            obs.set_tracer(None)
            obs.set_metrics(None)
            obs.set_postmortem_dir(None)
            obs.get_flight().clear()
    clean()
    yield
    clean()


def _join_stage_workers():
    for th in threading.enumerate():
        if th.name.startswith("mesh-stage:"):
            th.join(60)
            assert not th.is_alive()


def _io(name):
    gj, wj, gt, wt, x = model(name)
    return gj, wj, gt, wt, x, torch.from_numpy(x)


def _one_node_plan(g):
    return Plan(((Scheme.INH, Mode.T),) * len(g))


def _searched(g, nodes):
    return plan_search(g, AnalyticEstimator(),
                       TorchTestbed(nodes=nodes, bandwidth_gbps=0.5)).plan


def _run(g, w, x, plan, nodes, **cfg):
    return Session(g, w, plan, nodes, ExecConfig(executor="mesh", **cfg,
                                                 **CPU)).run(x)


def _check_spans(tr, stats):
    spans = tr.spans(cat=tobs.STAGE_CAT, track=tobs.CONTROL_TRACK)
    assert len(spans) == len(stats.stage_times) > 0
    assert [sp["name"] for sp in spans] == \
        [st.label for st in stats.stage_times]
    assert [sp["args"]["kind"] for sp in spans] == \
        [st.kind for st in stats.stage_times]
    for sp, st in zip(spans, stats.stage_times):
        assert sp["dur"] == pytest.approx(st.wall_s * 1e6)
    dev = tr.spans(cat="device")
    assert len(dev) == sum(len(st.device_done_s) for st in stats.stage_times)
    want = sorted((tobs.device_track(d), st.label, done * 1e6)
                  for st in stats.stage_times
                  for d, done in enumerate(st.device_done_s))
    got = sorted((sp["track"], sp["name"], sp["dur"]) for sp in dev)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert [g[2] for g in got] == pytest.approx([w[2] for w in want])


# ---------------------------------------------------------------------------
# tests/test_mesh_exec.py:344-442 on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,nodes,overlap", [
    ("mobilenet", 1, True), ("mobilenet", 4, True), ("mobilenet", 4, False),
    ("resnet18", 2, False), ("bert", 4, True)])
def test_stage_spans_match_stage_times_one_to_one(name, nodes, overlap):
    _, _, g, w, _, x = _io(name)
    plan = _one_node_plan(g) if nodes == 1 else _searched(g, nodes)
    tr = tobs.set_tracer(tobs.Tracer())
    try:
        _, s = _run(g, w, x, plan, nodes, instrument=True, overlap=overlap)
    finally:
        tobs.set_tracer(None)
    _check_spans(tr, s)
    if nodes > 1:
        assert any(st.device_done_s for st in s.stage_times)


@pytest.mark.parametrize("name,nodes", [("mobilenet", 1), ("mobilenet", 4),
                                        ("resnet18", 4), ("bert", 2)])
def test_tracing_is_bit_identical(name, nodes):
    """The default (no tracer) and traced runs agree bit for bit on the
    outputs and on ``ExecStats``; the traced run of a cached (already
    made) stage program still records every stage."""
    assert tobs.get_tracer() is None
    _, _, g, w, _, x = _io(name)
    plan = _one_node_plan(g) if nodes == 1 else _searched(g, nodes)
    sess = Session(g, w, plan, nodes, ExecConfig(executor="mesh",
                                                 instrument=True, **CPU))
    ref, s_ref = sess.run(x)
    tr = tobs.set_tracer(tobs.Tracer())
    try:
        out, s = sess.run(x)
    finally:
        tobs.set_tracer(None)
    assert torch.equal(out, ref)
    assert s == s_ref
    assert [st.label for st in s.stage_times] == \
        [st.label for st in s_ref.stage_times]
    _check_spans(tr, s)
    plain, s_plain = _run(g, w, x, plan, nodes)
    assert torch.equal(plain, ref) and s_plain == s_ref


def test_watchdog_timeout_dumps_postmortem(tmp_path):
    """A tripped stage watchdog leaves a postmortem artifact carrying
    the failing stage's span context (kind/label/timeout) and the
    recent flight-ring events, including that stage's dispatch."""
    _, _, g, w, _, x = _io("mobilenet")
    tobs.set_postmortem_dir(str(tmp_path))
    try:
        with pytest.raises(StageTimeoutError):
            _run(g, w, x, _one_node_plan(g), 1, stage_timeout_s=1e-4)
    finally:
        tobs.set_postmortem_dir(None)
    _join_stage_workers()
    dumps = sorted(tmp_path.glob("postmortem-*-stage_timeout.json"))
    assert len(dumps) == 1
    doc = json.loads(dumps[0].read_text())
    assert doc["reason"] == "stage_timeout"
    ctx = doc["context"]
    assert ctx["timeout_s"] == pytest.approx(1e-4)
    assert ctx["kind"] in ("compute", "sync") and ctx["label"]
    assert ctx["nodes"] == 1 and ctx["attempt"] == 0
    kinds = [(e["kind"], e.get("label")) for e in doc["events"]]
    assert ("stage_dispatch", ctx["label"]) in kinds
    assert ("stage_timeout", ctx["label"]) in kinds


def test_no_postmortem_dir_means_no_artifact(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert tobs.postmortem_dir() is None
    _, _, g, w, _, x = _io("mobilenet")
    with pytest.raises(StageTimeoutError):
        _run(g, w, x, _one_node_plan(g), 1, stage_timeout_s=1e-4)
    _join_stage_workers()
    assert list(tmp_path.rglob("postmortem-*")) == []


# ---------------------------------------------------------------------------
# the flight ring against the reference's
# ---------------------------------------------------------------------------

def _ring(obs):
    return [(e["kind"], e.get("stage_kind"), e.get("label"),
             e.get("attempt"), e.get("attempts"))
            for e in obs.get_flight().events()]


def _observe(obs, run, tmp_path, side):
    """``run()``'s outcome under a tracer, with its flight ring, its retry
    instants and the contexts of the postmortems it dumped."""
    d = tmp_path / side
    obs.set_postmortem_dir(str(d))
    tr = obs.set_tracer(obs.Tracer())
    obs.get_flight().clear()
    try:
        try:
            _, st = run()
            outcome = ("ok", st.retries, st.timeouts, st.fallbacks,
                       [(t.kind, t.label) for t in st.stage_times])
        except Exception as exc:        # compared across the packages
            outcome = ("raised", type(exc).__name__)
    finally:
        obs.set_tracer(None)
        obs.set_postmortem_dir(None)
    docs = []
    for p in sorted(d.glob("postmortem-*.json"),
                    key=lambda p: int(p.name.split("-")[2])):
        doc = json.loads(p.read_text())
        docs.append((doc["reason"], doc["context"],
                     [(e["kind"], e.get("label")) for e in doc["events"]]))
    instants = [(r["name"], r["cat"], r["args"]) for r in tr._records
                if r["ph"] == "i"]
    ring = _ring(obs)
    obs.get_flight().clear()
    return dict(outcome=outcome, ring=ring, instants=instants, docs=docs)


def _faults(timeout_cls):
    """Fault hooks by name: fail every stage's first attempt, fail always,
    time out the third stage."""
    def transient():
        failed = set()

        def hook(kind, label, attempt):
            if (kind, label) not in failed:
                failed.add((kind, label))
                raise OSError(f"injected transient fault at {label}")
        return hook

    def persistent():
        def hook(kind, label, attempt):
            raise OSError("injected persistent fault")
        return hook

    def timeout():
        seen = []

        def hook(kind, label, attempt):
            seen.append(label)
            if len(seen) == 3:
                raise timeout_cls(f"injected timeout at {label}")
        return hook
    return {"none": lambda: None, "transient": transient,
            "persistent": persistent, "timeout": timeout}


CASES = {"clean": ("none", {}),
         "retried": ("transient", dict(stage_retries=1)),
         "exhausted": ("persistent", dict(stage_retries=2)),
         "degraded": ("persistent", dict(stage_retries=1,
                                         fallback="local")),
         "timeout": ("timeout", dict(stage_retries=3)),
         "timeout-degraded": ("timeout", dict(fallback="local"))}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flight_ring_equals_the_reference(case, tmp_path):
    gj, wj, gt, wt, x, xt = _io("mobilenet")
    plan = _one_node_plan(gt)
    fault, kw = CASES[case]
    ref = _observe(jobs, lambda: j_mesh_exec.run_partitioned_mesh(
        gj, wj, x, to_jplan(plan), 1, instrument=True,
        fault_hook=_faults(j_mesh_exec.StageTimeoutError)[fault](), **kw),
        tmp_path, "ref")
    port = _observe(tobs, lambda: run_partitioned_mesh(
        gt, wt, xt, plan, 1, instrument=True,
        fault_hook=_faults(StageTimeoutError)[fault](), **kw),
        tmp_path, "port")
    assert port == ref
    kinds = [k for k, *_ in ref["ring"]]
    assert kinds.count("stage_dispatch") >= \
        (1 if fault == "persistent" else 3)
    if case == "retried":
        assert "stage_retry" in kinds and ref["instants"]
        assert all(n.startswith("retry:") for n, _, _ in ref["instants"])
    if case == "degraded":
        assert kinds[-2:] == ["stage_dispatch_error", "fallback_local"]
        assert [r for r, _, _ in ref["docs"]] == ["stage_dispatch_error"]


@pytest.mark.parametrize("name,nodes,overlap", [("mobilenet", 4, False),
                                                ("mobilenet", 4, True),
                                                ("resnet18", 2, False),
                                                ("bert", 4, False)])
def test_ring_holds_one_dispatch_per_measured_stage(name, nodes, overlap):
    gj, _, g, w, _, x = _io(name)
    plan = _searched(g, nodes)
    _, s = _run(g, w, x, plan, nodes, instrument=True, overlap=overlap)
    assert _ring(tobs) == [("stage_dispatch", st.kind, st.label, None, None)
                           for st in s.stage_times]
    if not overlap:
        v = validate_stage_decomposition(
            s, j_build_stages(gj, to_jplan(plan), j_homogeneous(nodes)))
        assert v["structure_match"], (v["missing"], v["extra"])
    assert np.isfinite([st.wall_s for st in s.stage_times]).all()
    assert mesh_exec.mesh_program_cache_info().currsize > 0
