"""The port's observability package (``repro_torch.obs``) against the
JAX package's ``repro.obs``, in one process.

* Every case of the reference's ``tests/test_obs.py`` runs on the port:
  the reference's test function, its module globals bound to
  ``repro_torch.obs`` in place of ``repro.obs``.
* The same calls on both packages give equal results: Perfetto exports
  (timestamps normalised by a shared fake clock, or dropped on the real
  clock), metrics snapshots and exported files, postmortem documents (keys
  and ring), ``REPRO_LOG`` lines in every mode, and ``stage_skew`` /
  ``diff_traces`` results.
"""
import importlib
import inspect
import itertools
import json
import os
import types

import pytest

import repro.obs as ref_obs
import repro_torch.obs as port_obs
import test_obs as ref_tests

PACKAGES = {"repro": ref_obs, "repro_torch": port_obs}


def mod(obs, name: str):
    """Submodule ``name`` of the obs package ``obs`` (``from .log import
    log`` in the package shadows the submodule attribute with the
    function, so go through importlib)."""
    return importlib.import_module(f"{obs.__name__}.{name}")


@pytest.fixture(autouse=True)
def _clean_obs_globals():
    """Every test starts and ends with observability uninstalled in both
    packages."""
    def clean():
        for obs in PACKAGES.values():
            obs.set_tracer(None)
            obs.set_metrics(None)
            obs.set_postmortem_dir(None)
            obs.get_flight().clear()
    clean()
    yield
    clean()


# ---------------------------------------------------------------------------
# the reference's own cases, run on the port
# ---------------------------------------------------------------------------

def _port_namespace() -> dict:
    """The reference test module's globals with every ``repro.obs`` name
    and submodule replaced by the port's, and its functions rebound to
    them."""
    g = dict(vars(ref_tests))
    for name in port_obs.__all__:
        if name in g:
            g[name] = getattr(port_obs, name)
    g["obstrace"] = mod(port_obs, "trace")
    g["obsmetrics"] = mod(port_obs, "metrics")
    g["obslog"] = mod(port_obs, "log")
    for k, v in list(g.items()):
        if isinstance(v, types.FunctionType) \
                and v.__module__ == ref_tests.__name__:
            g[k] = types.FunctionType(v.__code__, g, k, v.__defaults__,
                                      v.__closure__)
    left = sorted(k for k, v in g.items()
                  if (getattr(v, "__name__", "") or "").startswith(
                      "repro.obs")
                  or str(getattr(v, "__module__", "")).startswith(
                      "repro.obs"))
    assert left == [], f"reference names left unbound: {left}"
    return g


REF_CASES = sorted(n for n, v in vars(ref_tests).items()
                   if n.startswith("test_") and callable(v))


def test_every_reference_case_is_collected():
    assert len(REF_CASES) == 30


@pytest.mark.parametrize("name", REF_CASES)
def test_reference_case_holds_on_the_port(name, request):
    fn = _port_namespace()[name]
    args = {p: request.getfixturevalue(p)
            for p in inspect.signature(fn).parameters}
    fn(**args)


def test_exports_equal_the_reference():
    assert port_obs.__all__ == ref_obs.__all__
    for name in ("CONTROL_TRACK", "PLANNER_TRACK", "STAGE_CAT"):
        assert getattr(port_obs, name) == getattr(ref_obs, name)
    assert mod(port_obs, "log").ENV == mod(ref_obs, "log").ENV \
        == "REPRO_LOG"
    for name in ("POSTMORTEM_ENV", "SPAN_TAIL"):
        assert getattr(mod(port_obs, "flight"), name) == \
            getattr(mod(ref_obs, "flight"), name)
    assert [port_obs.device_track(i) for i in range(3)] == \
        [ref_obs.device_track(i) for i in range(3)]
    assert port_obs.link_track(2) == ref_obs.link_track(2)


# ---------------------------------------------------------------------------
# the same calls on both packages
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_clock(monkeypatch):
    """Give each package's trace and flight modules its own copy of one
    deterministic clock (a step of 1.5 us a call), so that equal call
    sequences produce equal timestamps."""
    def install(obs):
        ticks = itertools.count()
        clock = types.SimpleNamespace(
            perf_counter=lambda: 100.0 + 1.5e-6 * next(ticks))
        for name in ("trace", "flight"):
            monkeypatch.setattr(mod(obs, name), "time", clock)
    return install


def _trace_scenario(obs, tmp_path):
    """Spans (nested, failed), instants, externally timed spans, a second
    tracer of another pid, and what the exports and readers return."""
    tr = obs.set_tracer(obs.Tracer())
    with obs.span(obs.PLANNER_TRACK, "outer", cat="planner", graph="g") \
            as sp:
        with obs.span(obs.PLANNER_TRACK, "inner", layers=3) as inner:
            inner.set(rows=7)
            inner.event("marker", detail="x")
        sp.set(points=2)
    with pytest.raises(RuntimeError):
        with tr.span(obs.CONTROL_TRACK, "boom", cat=obs.STAGE_CAT):
            raise RuntimeError("x")
    mod(obs, "trace").instant(obs.CONTROL_TRACK, "retry:seg", attempt=0)
    tr.instant(obs.PLANNER_TRACK, "detect", cat="planner", t_sim=3.0)
    for d in range(3):
        tr.add_complete(obs.device_track(d), "seg[a..b]", 10.0 + d,
                        4.0 * (d + 1), cat="device", args={"kind": "c"})
    tr.add_complete(obs.CONTROL_TRACK, "seg[a..b]", 10.0, 12.0,
                    cat=obs.STAGE_CAT, args={"kind": "compute"})
    sim = obs.Tracer(process="simulated", pid=2)
    sim.ensure_track(obs.device_track(1))
    sim.add_complete(obs.link_track(0), "bound@b", 0.0, 3.0,
                     cat=obs.STAGE_CAT)
    path = str(tmp_path / f"{obs.__name__}.trace.json")
    obs.write_trace(path, tr, sim)
    loaded = obs.load_trace(path)
    obs.set_tracer(None)
    with open(path) as f:
        text = f.read()
    return {
        "perfetto": tr.to_perfetto(), "sim": sim.to_perfetto(),
        "file": text, "loaded": loaded, "len": (len(tr), len(sim)),
        "spans": tr.spans(), "stage": tr.spans(cat=obs.STAGE_CAT),
        "dev1": tr.spans(track=obs.device_track(1)),
        "events": obs.span_events(loaded),
        "events_stage_pid1": obs.span_events(loaded, cat=obs.STAGE_CAT,
                                             pid=1),
        "events_dev0": obs.span_events(loaded,
                                       track=obs.device_track(0)),
        "tracks": dict(tr._tracks),
        "null": obs.span(obs.CONTROL_TRACK, "off") is obs.NULL_SPAN,
    }


def test_perfetto_exports_equal_under_a_shared_clock(tmp_path, fake_clock):
    got = {}
    for pkg, obs in PACKAGES.items():
        fake_clock(obs)
        d = tmp_path / pkg
        d.mkdir()
        got[pkg] = _trace_scenario(obs, d)
    assert got["repro_torch"] == got["repro"]
    assert got["repro"]["null"] is True
    assert len(got["repro"]["stage"]) == 2


def _drop_clock(doc):
    """A trace export without the host clock's values: timestamps and
    durations of clock-timed records are set to None, the rest kept."""
    if isinstance(doc, dict):
        return {k: (None if k in ("ts", "dur") else _drop_clock(v))
                for k, v in doc.items()}
    if isinstance(doc, list):
        return [_drop_clock(v) for v in doc]
    return doc


def test_perfetto_exports_equal_on_the_real_clock(tmp_path):
    got = {}
    for pkg, obs in PACKAGES.items():
        d = tmp_path / pkg
        d.mkdir()
        res = _trace_scenario(obs, d)
        res.pop("file")
        # the record order follows the clock; compare as sorted multisets
        got[pkg] = {k: (sorted(json.dumps(e, sort_keys=True)
                               for e in _drop_clock(v)["traceEvents"])
                        if k in ("perfetto", "sim", "loaded")
                        else sorted(json.dumps(e, sort_keys=True)
                                    for e in _drop_clock(v))
                        if isinstance(v, list) else v)
                    for k, v in res.items()}
    assert got["repro_torch"] == got["repro"]


def _metrics_scenario(obs, tmp_path):
    metrics = mod(obs, "metrics")
    metrics.inc("ghost")
    metrics.gauge("ghost", 1.0)
    metrics.observe("ghost", 1.0)
    m = obs.set_metrics(obs.Metrics())
    assert obs.get_metrics() is m
    metrics.inc("hits")
    metrics.inc("hits", 2.5)
    metrics.inc("hits", table="i")
    metrics.inc("cost_tables.dedup_hits", 17, table="s")
    m.inc("replan.reuse", 1.0, path="svals")
    m.inc("labels", b=2, a="x")
    metrics.gauge("refine.beta", 0.5, graph="g")
    metrics.gauge("refine.beta", 0.75, graph="g")
    m.gauge("refine.alpha", 3, graph="h")
    for v in (0.0, -1.0, 0.5, 1.0, 3.0, 3.0, 1e-9, 7e6):
        metrics.observe("lat", v)
    m.observe("lat", 2.0, graph="g")
    out = {
        "snapshot": m.snapshot(),
        "counter": (m.counter_value("hits"),
                    m.counter_value("hits", table="i"),
                    m.counter_value("labels", a="x", b=2),
                    m.counter_value("nothing")),
        "gauge": (m.gauge_value("refine.beta", graph="g"),
                  m.gauge_value("refine.beta")),
    }
    path = str(tmp_path / f"{obs.__name__}.metrics.json")
    assert m.export(path) == path
    with open(path) as f:
        out["file"] = f.read()
    obs.set_metrics(None)
    return out


def test_metrics_snapshots_and_exports_equal(tmp_path):
    got = {pkg: _metrics_scenario(obs, tmp_path)
           for pkg, obs in PACKAGES.items()}
    assert got["repro_torch"] == got["repro"]
    assert got["repro"]["snapshot"]["counters"]["hits"] == 3.5


def _flight_scenario(obs, tmp_path, monkeypatch):
    flight = mod(obs, "flight")
    fr = obs.FlightRecorder(capacity=3)
    for i in range(5):
        fr.record("tick", i=i, label=f"s{i}")
    ring = {"events": fr.events(), "len": len(fr),
            "total": fr.total_recorded}
    fr.clear()
    ring["after_clear"] = (len(fr), fr.total_recorded)
    with pytest.raises(ValueError, match="capacity"):
        obs.FlightRecorder(capacity=0)

    monkeypatch.delenv(flight.POSTMORTEM_ENV, raising=False)
    docs = {"none": obs.dump_postmortem("unit_test")}
    d = tmp_path / obs.__name__
    obs.set_postmortem_dir(str(d))
    g = obs.get_flight()
    g.record("stage_dispatch", stage_kind="compute", label="seg[a..b]")
    g.record("stage_timeout", stage_kind="compute", label="seg[a..b]",
             timeout_s=1e-4)
    tr = obs.set_tracer(obs.Tracer())
    for k in range(flight.SPAN_TAIL + 3):
        tr.add_complete(obs.CONTROL_TRACK, f"s{k}", float(k), 1.0,
                        cat=obs.STAGE_CAT)
    paths = [obs.dump_postmortem(
        "stage_timeout", context={"kind": "compute", "label": "seg[a..b]",
                                  "timeout_s": 1e-4, "nodes": 4,
                                  "attempt": 0})]
    obs.set_tracer(None)
    obs.set_postmortem_dir(None)
    monkeypatch.setenv(flight.POSTMORTEM_ENV, str(d / "env"))
    paths.append(obs.dump_postmortem("refine_oscillation",
                                     context={"cycle": [1, 2, 1],
                                              "beta": 0.5}))
    paths.append(obs.dump_postmortem("explicit", directory=str(d / "x")))
    monkeypatch.delenv(flight.POSTMORTEM_ENV)
    for p in paths:
        assert p is not None and p.startswith(str(d))
        with open(p) as f:
            doc = json.load(f)
        # the file name carries the pid and a process-wide sequence
        # number; the rest of it is the reason
        base = os.path.basename(p)
        assert base.startswith(f"postmortem-{os.getpid()}-")
        docs[base.split("-", 3)[3]] = doc
    return {"ring": ring, "docs": docs}


def test_postmortems_equal_by_keys_and_ring(tmp_path, monkeypatch,
                                            fake_clock):
    got = {}
    for pkg, obs in PACKAGES.items():
        fake_clock(obs)
        got[pkg] = _flight_scenario(obs, tmp_path, monkeypatch)
    ref, port = got["repro"], got["repro_torch"]
    assert port["ring"] == ref["ring"]
    assert sorted(port["docs"]) == sorted(ref["docs"])
    for name, doc in ref["docs"].items():
        if doc is None:
            assert port["docs"][name] is None
            continue
        assert sorted(port["docs"][name]) == sorted(doc) == \
            ["context", "events", "reason", "spans"]
        # the process-wide ring's clock starts at its import, which differs
        # between the packages: its events compare without their times
        assert [{k: v for k, v in e.items() if k != "t_us"}
                for e in port["docs"][name].pop("events")] == \
            [{k: v for k, v in e.items() if k != "t_us"}
             for e in doc.pop("events")]
        assert port["docs"][name] == doc, name
    assert len(ref["docs"]["stage_timeout.json"]["spans"]) == \
        mod(ref_obs, "flight").SPAN_TAIL


LOG_CALLS = (
    ("train.step", {"step": 3, "loss": 0.25}),
    ("gbdt.fit", {"tree": 40, "train_rmse": 0.123456789123,
                  "eval_rmse": 1e-12}),
    ("serve.timing", {"batch": 4, "prefill_ms": 1.5, "name": "a b",
                      "shape": (2, 3), "none": None, "flag": True,
                      "nested": {"k": [1, 2.5]}}),
    ("bare", {}),
)
LOG_MODES = (None, "", "0", "off", "false", "OFF", "1", "yes", "JSON",
             "json")


@pytest.mark.parametrize("mode", LOG_MODES)
def test_log_lines_equal(mode, monkeypatch, capsys):
    got = {}
    for pkg, obs in PACKAGES.items():
        log = mod(obs, "log")
        if mode is None:
            monkeypatch.delenv(log.ENV, raising=False)
        else:
            monkeypatch.setenv(log.ENV, mode)
        enabled = log.enabled()
        for event, fields in LOG_CALLS:
            log.log(event, **fields)
        out = capsys.readouterr()
        assert out.out == ""
        got[pkg] = (enabled, out.err)
    assert got["repro_torch"] == got["repro"]
    on = mode not in (None, "", "0", "off", "false", "OFF")
    assert got["repro"][0] is on and bool(got["repro"][1]) is on


SKEW_INPUTS = (
    [],
    [{"kind": "compute", "label": "seg[a..b]", "sim_s": 1.0,
      "measured_s": 2.0},
     {"kind": "sync", "label": "bound@b", "sim_s": 0.5, "measured_s": 0.25},
     {"kind": "sync", "label": "gather", "sim_s": 0.0, "measured_s": 0.1},
     {"kind": "compute", "label": "seg[c..c]", "sim_s": 1.0,
      "measured_s": None}],
    [{"kind": "compute", "label": f"s{i}", "sim_s": 1e-4 * (i + 1),
      "measured_s": 3e-4 * (i + 2) ** 1.5} for i in range(7)],
    [{"kind": "sync", "label": "x", "sim_s": -1.0, "measured_s": 1.0},
     {"label": "y", "measured_s": 2.0}],
)


def _stage_trace(obs, pid, names_durs, process, track=None):
    tr = obs.Tracer(process=process, pid=pid)
    t = 0.0
    for name, dur in names_durs:
        tr.add_complete(track or obs.CONTROL_TRACK, name, t, dur,
                        cat=obs.STAGE_CAT)
        t += dur
    return tr.to_perfetto()


def _diff_cases(obs):
    m = _stage_trace(obs, 1, [("a", 2.0), ("b", 1.0), ("a", 5.0)],
                     "measured")
    s = _stage_trace(obs, 2, [("a", 1.0), ("b", 1.0)], "simulated",
                     track=obs.device_track(0))
    x = _stage_trace(obs, 1, [("a", 1.0), ("x", 0.0)], "measured")
    merged = {"traceEvents": m["traceEvents"] + s["traceEvents"]}
    return [obs.diff_traces(m, s), obs.diff_traces(x, s),
            obs.diff_traces(s, x), obs.diff_traces(m, s, cat="device"),
            obs.diff_traces(merged, merged, measured_pid=1,
                            simulated_pid=2)]


def test_skew_results_equal():
    got = {pkg: ([obs.stage_skew(st) for st in SKEW_INPUTS],
                 _diff_cases(obs))
           for pkg, obs in PACKAGES.items()}
    assert got["repro_torch"] == got["repro"]
    skews, diffs = got["repro"]
    assert skews[2]["n_paired"] == 7 and diffs[0]["structure_match"]
    assert not diffs[1]["structure_match"]
