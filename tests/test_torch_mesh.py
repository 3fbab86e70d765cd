"""The port's mesh executor (``Session(..., ExecConfig(executor="mesh"))``)
on CPU tensors, the port of ``tests/test_mesh_exec.py``.

* equivalence on the chain models against the JAX local ``Session`` and
  the port's local executor at 2/4/8 nodes and the 3-node GRID2D plan
  (the DAG models are in ``test_torch_mesh_dag.py``, on another worker);
* a 1-node plan runs plain programs, bit-equal to the local executor;
* the overlapped halo exchange: fused into the producing compute stage
  with ``overlap=True``, a sync stage of its own without;
* the mesh of nodes (the one-card mapping, too few devices, several
  devices), the knobs and the fault policy (retries, timeouts, the
  watchdog, degrade-to-local), the failure counters and the measurement
  hand-off (``ExecStats.to_occupancy``), the stage-decomposition
  validator and the stage-program cache.

The nodes of a CPU mesh have no streams and run one after another; the
card's streams are exercised in ``test_torch_gpu.py``.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.cluster.simsched import Stage

from repro_torch import (EXECUTORS, AnalyticEstimator, ExecConfig, ExecStats,
                         Mode, Plan, Scheme, Session, init_weights,
                         make_nodes_mesh, plan_search)
from repro_torch import Testbed as TorchTestbed
from repro_torch.core.graph import ConvT, LayerSpec, chain
from repro_torch.launch.mesh import NodesMesh
from repro_torch.runtime import mesh_exec
from repro_torch.runtime.engine import MeasuredOccupancy, StageTime
from repro_torch.runtime.mesh_exec import (StageDispatchError,
                                           StageTimeoutError,
                                           clear_mesh_program_cache,
                                           mesh_program_cache_info,
                                           run_partitioned_mesh,
                                           validate_stage_decomposition)
from torch_conformance import MESH_PLANS, check_mesh, model

CPU = dict(device="cpu")


def run(g, w, x, plan, nodes, **cfg):
    """Session-API sugar for this module's config sweeps, on the CPU."""
    return Session(g, w, plan, nodes, ExecConfig(**cfg, **CPU)).run(x)


def _model_io(name):
    _, _, g, w, x = model(name)
    return g, w, torch.from_numpy(x)


def _one_node_plan(g):
    return Plan(((Scheme.INH, Mode.T),) * len(g))


@pytest.mark.parametrize("kind", MESH_PLANS)
@pytest.mark.parametrize("name", ["bert", "mobilenet"])
def test_mesh_matches_jax_session(name, kind):
    check_mesh(name, kind)


@pytest.mark.parametrize("name", ["mobilenet", "resnet18"])
def test_one_node_plan_runs_plain_programs(name):
    """nodes=1: no mesh is built and nothing is exchanged — output and
    stats are bit-identical to the local executor."""
    g, w, x = _model_io(name)
    plan = plan_search(g, AnalyticEstimator(),
                       TorchTestbed(nodes=1, bandwidth_gbps=0.5)).plan
    ref, s_ref = run(g, w, x, plan, 1)
    sess = Session(g, w, plan, 1, ExecConfig(executor="mesh", **CPU))
    assert sess.mesh is None
    out, s = sess.run(x)
    assert torch.equal(out, ref)
    assert s == s_ref


def test_one_node_instrumented_stats():
    g, w, x = _model_io("mobilenet")
    _, s = run(g, w, x, _one_node_plan(g), 1, executor="mesh",
               instrument=True)
    assert s.stage_times and s.wall_s > 0.0
    assert {st.kind for st in s.stage_times} == {"compute", "sync"}
    occ = s.to_occupancy()
    assert occ.period_s == max(occ.dev_occupancy_s, occ.link_occupancy_s)
    assert occ.latency_s >= 0.0


def _flat_chain():
    """Constant-resolution chain: 6x conv3x3 s1 p1 over 24x24 rows, 6
    rows a node at 4 nodes, 1-2 halo rows a 2-layer segment."""
    convs = [LayerSpec(f"c{i}", ConvT.CONV, 24, 24, 8, 8, 3, 1, 1)
             for i in range(6)]
    g = chain("flatchain", convs)
    w = init_weights(g, torch.Generator().manual_seed(0), "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (24, 24, 8)).astype(np.float32))
    steps = [(Scheme.INH, Mode.T if i % 2 == 1 else Mode.NT)
             for i in range(len(g))]
    return g, w, x, Plan(tuple(steps))


def test_mesh_overlapped_halo_exchange():
    """Same-scheme boundaries take the halo exchange: on a
    constant-resolution conv chain overlap=True fuses every exchange into
    the producing compute stage, overlap=False dispatches each as its own
    sync stage.  On MobileNet with a T every third layer the deep
    boundaries are not eligible and fall back to the gather, and
    overlap=True still has fewer bound@ stages."""
    g, w, x, plan = _flat_chain()
    ref, s_ref = run(g, w, x, plan, 4)
    for overlap in (True, False):
        out, s = run(g, w, x, plan, 4, executor="mesh", instrument=True,
                     overlap=overlap)
        assert torch.allclose(out, ref, rtol=0, atol=1e-4 * max(
            1.0, float(ref.abs().max())))
        assert s == s_ref
        syncs = [st.label for st in s.stage_times if st.kind == "sync"]
        bounds = [lab for lab in syncs if lab.startswith("bound@")]
        if overlap:
            assert not bounds, syncs
        else:
            assert bounds == ["bound@c1", "bound@c3"], syncs
    g, w, x = _model_io("mobilenet")
    steps = [(Scheme.INH, Mode.T if (i % 3 == 2) else Mode.NT)
             for i in range(len(g))]
    steps[-1] = (Scheme.INH, Mode.T)
    plan = Plan(tuple(steps))
    ref, s_ref = run(g, w, x, plan, 4)
    n_bounds = {}
    for overlap in (True, False):
        out, s = run(g, w, x, plan, 4, executor="mesh", instrument=True,
                     overlap=overlap)
        scale = max(1.0, float(ref.abs().max()))
        assert float((out - ref).abs().max()) / scale < 1e-4
        assert s == s_ref
        n_bounds[overlap] = sum(
            1 for st in s.stage_times
            if st.kind == "sync" and st.label.startswith("bound@"))
    assert n_bounds[True] < n_bounds[False], n_bounds


def test_program_cache_second_run_makes_no_program():
    """A Session's second run hits a program for every stage of its
    first and makes none."""
    g, w, x, plan = _flat_chain()
    clear_mesh_program_cache()
    sess = Session(g, w, plan, 4, ExecConfig(executor="mesh", **CPU))
    first, _ = sess.run(x)
    info = mesh_program_cache_info()
    assert info.misses == info.currsize > 0 and info.hits == 0
    again, _ = sess.run(x)
    info2 = mesh_program_cache_info()
    assert info2.misses == info.misses
    assert info2.hits == info.currsize == info2.currsize
    assert torch.equal(first, again)
    clear_mesh_program_cache()
    assert mesh_program_cache_info() == (0, 0, None, 0)


# ---------------------------------------------------------------------------
# the mesh of nodes and the knobs
# ---------------------------------------------------------------------------

def test_executors_constant():
    assert EXECUTORS == ("local", "mesh")


def test_one_card_mapping_puts_every_node_on_one_device():
    mesh = make_nodes_mesh(4, ["cpu"])
    assert mesh.shape == {"nodes": 4}
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert mesh.streams == ()           # no streams on the CPU
    assert make_nodes_mesh(3, ["cpu"] * 5).shape == {"nodes": 3}
    with pytest.raises(ValueError, match="nodes"):
        make_nodes_mesh(0, ["cpu"])


def test_mesh_needs_devices():
    """A device list that cannot hold the nodes raises and names the
    one-card mapping; nodes on several devices are not ported."""
    g, w, x = _model_io("mobilenet")
    plan = plan_search(g, AnalyticEstimator(),
                       TorchTestbed(nodes=4, bandwidth_gbps=0.5)).plan
    with pytest.raises(RuntimeError, match="one-card mapping"):
        make_nodes_mesh(4, ["cpu", "cpu"])
    with pytest.raises(RuntimeError, match="one-card mapping"):
        run_partitioned_mesh(g, w, x, plan, 4, devices=["cpu", "cpu"])
    with pytest.raises(NotImplementedError, match="A 10"):
        make_nodes_mesh(2, ["cuda:0", "cuda:1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="not present"):
            make_nodes_mesh(2, ["cuda:0"])


def test_executor_validation():
    g, w, x = _model_io("mobilenet")
    plan = _one_node_plan(g)
    with pytest.raises(ValueError, match="executor"):
        run(g, w, x, plan, 1, executor="bogus")
    with pytest.raises(ValueError, match="backend"):
        run(g, w, x, plan, 1, executor="mesh", backend="bogus")
    with pytest.raises(ValueError, match="nodes"):
        run(g, w, x, plan, 0, executor="mesh")
    with pytest.raises(ValueError, match="mesh must be 1-D"):
        Session(g, w, plan, 4, ExecConfig(executor="mesh", **CPU),
                mesh=make_nodes_mesh(2, ["cpu"])).run(x)


def test_fault_knob_validation():
    for kw, match in ((dict(fallback="shrug"), "fallback"),
                      (dict(stage_retries=-1), "stage_retries"),
                      (dict(stage_timeout_s=0.0), "stage_timeout_s")):
        with pytest.raises(ValueError, match=match):
            ExecConfig(executor="mesh", **kw, **CPU)
    g, w, x = _model_io("mobilenet")
    with pytest.raises(ValueError, match="fallback"):
        run_partitioned_mesh(g, w, x, _one_node_plan(g), 1,
                             fallback="shrug")


# ---------------------------------------------------------------------------
# fault handling (1-node plans need no mesh)
# ---------------------------------------------------------------------------

def test_transient_fault_is_retried():
    """Every stage dispatch fails once: with stage_retries=1 the run
    completes, matches the local executor, and counts every re-attempt."""
    g, w, x = _model_io("mobilenet")
    plan = _one_node_plan(g)
    ref, s_ref = run(g, w, x, plan, 1)
    failed = set()

    def hook(kind, label, attempt):
        if (kind, label) not in failed:
            failed.add((kind, label))
            raise OSError(f"injected transient fault at {label}")

    out, s = run_partitioned_mesh(g, w, x, plan, 1, stage_retries=1,
                                  fault_hook=hook)
    assert torch.equal(out, ref)
    assert s.retries == len(failed) > 0
    assert s.timeouts == 0 and s.fallbacks == 0
    assert s.failure_count == s.retries
    assert s == s_ref


def test_persistent_fault_exhausts_retries():
    g, w, x = _model_io("mobilenet")

    def hook(kind, label, attempt):
        raise OSError("injected persistent fault")

    with pytest.raises(StageDispatchError,
                       match=r"failed after 3 attempt\(s\)"):
        run_partitioned_mesh(g, w, x, _one_node_plan(g), 1, stage_retries=2,
                             fault_hook=hook)


def test_persistent_fault_degrades_to_local():
    g, w, x = _model_io("mobilenet")
    plan = _one_node_plan(g)
    ref, _ = run(g, w, x, plan, 1)

    def hook(kind, label, attempt):
        raise OSError("injected persistent fault")

    out, s = run_partitioned_mesh(g, w, x, plan, 1, stage_retries=1,
                                  fallback="local", fault_hook=hook)
    assert torch.equal(out, ref)
    assert s.fallbacks == 1 and s.retries >= 1
    assert s.failure_count >= 2


def test_timeout_is_never_retried():
    g, w, x = _model_io("mobilenet")
    plan = _one_node_plan(g)
    ref, _ = run(g, w, x, plan, 1)

    def hook(kind, label, attempt):
        raise StageTimeoutError(f"injected timeout at {label}")

    out, s = run_partitioned_mesh(g, w, x, plan, 1, stage_retries=5,
                                  fallback="local", fault_hook=hook)
    assert torch.equal(out, ref)
    assert s.timeouts == 1
    assert s.retries == 0
    assert s.fallbacks == 1
    with pytest.raises(StageTimeoutError, match="injected timeout"):
        run_partitioned_mesh(g, w, x, plan, 1, stage_retries=5,
                             fault_hook=hook)


def test_real_watchdog_fires_with_actionable_message():
    """An unmeetable stage_timeout_s trips the watchdog on the first
    stage; the message names the port's likely causes and the remedy."""
    g, w, x = _model_io("mobilenet")
    with pytest.raises(StageTimeoutError,
                       match="first call of a stage program.*"
                             "fallback='local'"):
        run(g, w, x, _one_node_plan(g), 1, executor="mesh",
            stage_timeout_s=1e-4)
    _join_stage_workers()               # the abandoned stage finishes


def _slow_first_stage(monkeypatch, delay_s):
    """Make the first stage's worker take ``delay_s`` before its nodes
    run, as a slow first call or capture does."""
    run_nodes = NodesMesh.run
    slowed = []

    def slow(self, *phases, marks=None):
        if not slowed:
            slowed.append(threading.current_thread().name)
            time.sleep(delay_s)
        return run_nodes(self, *phases, marks=marks)
    monkeypatch.setattr(NodesMesh, "run", slow)
    return slowed


def _join_stage_workers():
    for th in threading.enumerate():
        if th.name.startswith("mesh-stage:"):
            th.join(60)
            assert not th.is_alive()


def test_timeout_fallback_waits_for_the_abandoned_worker(monkeypatch):
    """A stage that outlives stage_timeout_s with fallback='local':
    the local executor runs only once the abandoned worker has finished,
    so the two never share the device, and the degradation is counted."""
    g, w, x = _model_io("mobilenet")
    plan = _one_node_plan(g)
    ref, _ = run(g, w, x, plan, 1)
    slowed = _slow_first_stage(monkeypatch, 0.3)
    out, s = run(g, w, x, plan, 1, executor="mesh", stage_timeout_s=0.05,
                 fallback="local")
    assert slowed and slowed[0].startswith("mesh-stage:")
    assert not any(th.name.startswith("mesh-stage:")
                   for th in threading.enumerate())
    assert torch.equal(out, ref)
    assert s.timeouts == 1 and s.fallbacks == 1 and s.retries == 0


def test_timeout_fallback_refused_while_the_worker_runs(monkeypatch):
    """A timed-out stage whose worker outlives ABANDONED_JOIN_S refuses
    fallback='local' rather than run the local executor beside it."""
    g, w, x = _model_io("mobilenet")
    _slow_first_stage(monkeypatch, 0.5)
    monkeypatch.setattr(mesh_exec, "ABANDONED_JOIN_S", 0.01)
    with pytest.raises(StageTimeoutError, match="still runs.*refused"):
        run(g, w, x, _one_node_plan(g), 1, executor="mesh",
            stage_timeout_s=0.05, fallback="local")
    _join_stage_workers()


def test_generous_timeout_counts_nothing():
    g, w, x = _model_io("mobilenet")
    plan = _one_node_plan(g)
    ref, s_ref = run(g, w, x, plan, 1)
    out, s = run(g, w, x, plan, 1, executor="mesh", stage_timeout_s=300.0,
                 stage_retries=2)
    assert torch.equal(out, ref)
    assert s == s_ref
    assert s.failure_count == 0


def test_mesh_shrink_degrades_to_local():
    """A 4-node plan over two devices: with fallback='local' the mesh
    shortage degrades to the local executor instead of raising (cf.
    test_mesh_needs_devices), and counts it."""
    g, w, x = _model_io("mobilenet")
    plan = plan_search(g, AnalyticEstimator(),
                       TorchTestbed(nodes=4, bandwidth_gbps=0.5)).plan
    ref, _ = run(g, w, x, plan, 4)
    out, s = run_partitioned_mesh(g, w, x, plan, 4, devices=["cpu", "cpu"],
                                  fallback="local")
    assert torch.equal(out, ref)
    assert s.fallbacks == 1 and s.failure_count == 1


def test_failure_counters_break_stats_trust_not_equality():
    a, b = ExecStats(), ExecStats()
    a.retries, a.timeouts, a.fallbacks = 2, 1, 1
    assert a == b
    assert a.failure_count == 4 and b.failure_count == 0


# ---------------------------------------------------------------------------
# the measurement hand-off and the stage-decomposition validator
# ---------------------------------------------------------------------------

def test_to_occupancy_arithmetic():
    s = ExecStats()
    with pytest.raises(ValueError, match="instrument"):
        s.to_occupancy()
    s.stage_times = [
        StageTime("compute", "seg[a..b]", 0.5, (0.2, 0.5)),
        StageTime("compute", "seg[c..c]", 0.3, (0.3, 0.1)),
        StageTime("sync", "bound@b", 0.05),
        StageTime("sync", "gather", 0.1),
    ]
    s.wall_s = 0.95
    occ = s.to_occupancy()
    assert isinstance(occ, MeasuredOccupancy)
    # per-node sums: node 0 = 0.5, node 1 = 0.6 -> straggler 0.6
    assert occ.dev_occupancy_s == pytest.approx(0.6)
    assert occ.link_occupancy_s == pytest.approx(0.15)
    assert occ.period_s == pytest.approx(0.6)
    assert occ.latency_s == pytest.approx(0.95)


def test_to_occupancy_error_names_mesh_executor():
    with pytest.raises(ValueError, match=r'executor="mesh"'):
        ExecStats().to_occupancy()


def test_validate_stage_decomposition_pure():
    def sim(kind, label):
        return Stage(kind, (1.0,), (), label)

    stats = ExecStats()
    stats.stage_times = [
        StageTime("compute", "seg[a..b]", 0.1, (0.1,)),
        StageTime("sync", "bound@b", 0.01),
        StageTime("compute", "seg[c..d]", 0.2, (0.2,)),
        StageTime("sync", "reshard", 0.0),
        StageTime("sync", "gather", 0.02),
    ]
    stages = [sim("compute", "seg[a..b]"), sim("sync", "bound@b"),
              sim("compute", "seg[c..d]"), sim("sync", "gather")]
    v = validate_stage_decomposition(stats, stages)
    assert v["structure_match"] and not v["missing"] and not v["extra"]
    assert len(v["stages"]) == 4
    assert all(r["measured_s"] is not None for r in v["stages"])
    v2 = validate_stage_decomposition(
        stats, stages + [sim("sync", "fork->x")])
    assert not v2["structure_match"]
    assert v2["missing"] == [("sync", "fork->x")]
    stats3 = ExecStats()
    stats3.stage_times = [StageTime("sync", "merge->m", 0.01),
                          StageTime("compute", "seg[m..m]", 0.1, (0.1,))]
    stages3 = [sim("sync", "merge->m"), sim("compute", "seg[m..m]"),
               sim("sync", "bound@m")]
    v3 = validate_stage_decomposition(stats3, stages3)
    assert v3["structure_match"]
    assert v3["subsumed"] == [("sync", "bound@m")]
