"""The port's public surface (``repro_torch``) against the JAX package's:
every case of the reference's ``tests/test_api.py`` runs on the port
(``torch_ref_cases``: its source executed again with ``repro`` imports
redirected to ``repro_torch``), and the top-level names cover the
reference's.

Where the port's API rightly differs, the reference's source is edited
before it runs, each edit named in ``EDITS``:

* **Backends.**  The reference's are ``"xla"`` (default) and ``"pallas"``;
  the port's ``"cuda"`` (default: the hand-written kernels) and
  ``"torch"`` (generic ATen).  The cases use the names by role: ``"xla"``
  (the default) becomes ``"cuda"``, ``"pallas"`` (the other one)
  ``"torch"``, and ``"cuda"``, which the reference rejects and the port
  accepts, becomes ``"xla"``, a name the port rejects.
* **Devices.**  The port's ``Session`` and ``run_partitioned`` run on the
  card unless asked for the CPU: the cases get an ``ExecConfig``,
  ``Session`` and ``run_partitioned`` whose device is ``"cpu"``.
* **Weights and inputs.**  ``_toy`` draws them with torch's generator on
  the CPU (the port's ``init_weights`` takes a ``torch.Generator``, not a
  JAX key); ``test_session_reuse_across_inputs`` still feeds JAX arrays,
  which ``Session.run`` takes as it takes any array.
* ``importlib.import_module`` of ``repro...`` is redirected too, since the
  parametrized case imports its module by name.
"""
import dataclasses
import functools
import importlib
import types
import warnings

import pytest
import torch

import repro
import repro_torch
from repro_torch.runtime import engine, session
from torch_ref_cases import port_namespace, reference_cases

EDITS = (
    # role-for-role backend names (module docstring)
    ('ExecConfig(backend="cuda")', 'ExecConfig(backend="xla")'),
    ('res.plan, 4, backend="cuda")', 'res.plan, 4, backend="xla")'),
    ('cfg.backend = "xla"', 'cfg.backend = "cuda"'),
    ('dataclasses.replace(cfg, backend="xla")',
     'dataclasses.replace(cfg, backend="cuda")'),
    ('backend="pallas"', 'backend="torch"'),
)


def _toy():
    """The reference's toy chain, with the port's weights and input on the
    CPU."""
    from repro_torch.core import ConvT, LayerSpec, chain
    g = chain("toy", [
        LayerSpec("c0", ConvT.CONV, 16, 16, 3, 8, 3, 1, 1),
        LayerSpec("pw", ConvT.POINTWISE, 16, 16, 8, 16, 1, 1, 0),
        LayerSpec("c1", ConvT.CONV, 16, 16, 16, 8, 3, 1, 1),
    ])
    gen = torch.Generator().manual_seed(0)
    return (g, engine.init_weights(g, gen, device="cpu"),
            torch.randn((16, 16, 3), generator=gen))


def _import_module(name, package=None):
    if name == "repro" or name.startswith("repro."):
        name = "repro_torch" + name[len("repro"):]
    return importlib.import_module(name, package)


def _cpu_session(graph, weights, plan, nodes, config=None, **kw):
    return session.Session(graph, weights, plan, nodes,
                           config or session.ExecConfig(device="cpu"), **kw)


def _namespace() -> dict:
    ns = port_namespace("test_api", EDITS)
    ns["ExecConfig"] = functools.partial(session.ExecConfig, device="cpu")
    ns["Session"] = _cpu_session
    ns["run_partitioned"] = functools.partial(engine.run_partitioned,
                                              device="cpu")
    ns["_toy"] = _toy
    ns["importlib"] = types.SimpleNamespace(import_module=_import_module)
    return ns


PORT = _namespace()
CASES = reference_cases(PORT)
#: the parametrized case's arguments, from its decorator
MODS = ["repro", "repro.runtime", "repro.core", "repro.cluster"]


def test_the_reference_module_runs_on_the_port():
    assert len(CASES) == 8
    assert PORT["repro"] is repro_torch
    assert PORT["plan_search"].__module__ == "repro_torch.core.dpp"


@pytest.mark.parametrize("mod", MODS)
def test_reference_names_case_holds_on_the_port(mod):
    PORT["test_all_names_importable"](mod)


@pytest.mark.parametrize("name", [c for c in CASES
                                  if c != "test_all_names_importable"])
def test_reference_case_holds_on_the_port(name):
    PORT[name]()


def test_top_level_names_cover_the_reference():
    missing = [n for n in repro.__all__ if n not in repro_torch.__all__]
    assert missing == []
    for name in repro.__all__:
        ref, port = getattr(repro, name), getattr(repro_torch, name)
        assert type(ref).__name__ == type(port).__name__, name
        if isinstance(ref, type):
            assert ref.__name__ == port.__name__, name


def test_run_partitioned_equals_session_on_every_executor():
    """The shim's result and stats (but the wall clock) equal the Session
    it wraps, local and mesh, and it warns each call."""
    g, ws, x = _toy()
    res = repro_torch.plan_search(g, repro_torch.AnalyticEstimator(),
                                  repro_torch.Testbed(nodes=3))
    for executor in ("local", "mesh"):
        cfg = session.ExecConfig(executor=executor, device="cpu")
        want, wstats = session.Session(g, ws, res.plan, 3, cfg).run(x)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            got, stats = engine.run_partitioned(
                g, ws, x, res.plan, 3, executor=executor, device="cpu")
        assert [w.category for w in seen] == [DeprecationWarning]
        assert torch.equal(got, want)
        got_s, want_s = dataclasses.asdict(stats), dataclasses.asdict(wstats)
        got_s.pop("wall_s"), want_s.pop("wall_s")      # a clock
        assert got_s == want_s
