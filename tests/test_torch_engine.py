"""The port's engine and Session against the JAX package's.

Both packages get the same plan (converted by enum value), the same
weights (the JAX package's ``init_weights``, through ``np.asarray`` and
``weights_from_numpy``) and the same input (numpy, from a seed).  The
port runs on CPU tensors under both backends — ``"torch"`` (generic ATen)
and ``"cuda"`` (kernel dispatch, which on CPU tensors runs the kernels'
plain versions) — and must agree with the JAX ``Session`` within 1e-4 of
the output scale, with ``ExecStats`` equal field for field.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.edge_models import EDGE_MODELS as J_MODELS
from repro.runtime.engine import _apply_record as j_apply_record
from repro.runtime.session import ExecConfig as JExecConfig
from repro.runtime.session import Session as JSession

from repro_torch import (ExecConfig, Mode, Plan, Scheme, Session,
                         init_weights, weights_from_numpy)
from repro_torch.configs.edge_models import EDGE_MODELS
from repro_torch.core.graph import ConvT, conv_geometries
from repro_torch.runtime.engine import _apply_record, _apply_record_b

from torch_conformance import (MODEL_TEST_KW, PLANS, check_run_reference,
                               check_session, geometry_fields, model, plans,
                               rel_err)

CPU = ExecConfig(device="cpu")
#: the chain models here; the DAG models in test_torch_engine_dag.py (the
#: two files run on separate workers)
CHAINS = ["bert", "mobilenet"]


def test_model_split_covers_every_model():
    dags = ["inception", "resnet101", "resnet18"]
    assert sorted(CHAINS + dags) == sorted(J_MODELS)
    assert all(EDGE_MODELS[n]().is_chain for n in CHAINS)
    assert not any(EDGE_MODELS[n]().is_chain for n in dags)


@pytest.mark.parametrize("kind", PLANS)
@pytest.mark.parametrize("name", CHAINS)
def test_session_matches_reference(name, kind):
    check_session(name, kind)


@pytest.mark.parametrize("name", CHAINS)
def test_run_reference_matches(name):
    check_run_reference(name)


@pytest.mark.parametrize("name", ["mobilenet", "bert"])
def test_cuda_backend_matches_pallas_backend(name):
    """The port's kernel dispatch against the JAX Pallas backend in
    interpret mode: between them, both shard kernels."""
    gj, wj, gt, wt, x = model(name)
    pj, pt, nodes = plans(gj, "search-n4")
    out_j, st_j = JSession(gj, wj, pj, nodes,
                           JExecConfig(backend="pallas")).run(x)
    out, st = Session(gt, wt, pt, nodes,
                      ExecConfig(backend="cuda", device="cpu")).run(
                          torch.from_numpy(x))
    assert rel_err(out, out_j) < 1e-4
    assert geometry_fields(st) == geometry_fields(st_j)


def _other_geoms():
    geoms = set()
    for name, f in EDGE_MODELS.items():
        geoms.update(conv_geometries(f()))
        geoms.update(conv_geometries(f(**MODEL_TEST_KW[name])))
    return sorted(g for g in geoms
                  if g[0] not in (ConvT.CONV, ConvT.DWCONV, ConvT.POINTWISE))


OTHER_GEOMS = _other_geoms()


def _record_case(t, k, s, p):
    rng = np.random.default_rng(k * 7 + s)
    if t == ConvT.FC:
        cin, cout, seq = 24, 10, max(1, k)
        rec = (int(t), 1, 1, None, None, (0, cout))
        w = (rng.standard_normal((cin, cout)) * 0.1).astype(np.float32)
        x = rng.standard_normal((seq, 1, cin)).astype(np.float32)
    elif t in (ConvT.ADD, ConvT.CONCAT):
        rec = (int(t), k, s, None, None, (1, 5))
        w = None
        x = rng.standard_normal((6, 6, 8)).astype(np.float32)
    else:   # POOL
        h = max(k + s, 2 * s + k)
        rec = (int(t), k, s, (p, p, p, p), (0, h, 0, h), (0, 6))
        w = None
        x = rng.standard_normal((h, h, 6)).astype(np.float32)
    return rec, w, x


def _both_records(rec, w, x):
    wt = None if w is None else torch.from_numpy(w)
    xt = torch.from_numpy(x)
    return (j_apply_record(rec, None if w is None else jax.numpy.asarray(w),
                           jax.numpy.asarray(x)),
            _apply_record_b(rec, wt, xt, "cuda"),
            _apply_record(rec, wt, xt))


@pytest.mark.parametrize("t,k,s,p", OTHER_GEOMS,
                         ids=[f"{t.name}-k{k}-s{s}-p{p}"
                              for t, k, s, p in OTHER_GEOMS])
def test_non_conv_records_fall_back_identically(t, k, s, p):
    """POOL/FC/ADD/CONCAT records: the cuda backend's per-record dispatch
    (POOL via the geometry fallback, FC via the matmul kernel's wrapper,
    merges via slicing) agrees with the reference's XLA record path and
    the port's generic one."""
    rec, w, x = _record_case(t, k, s, p)
    want, got_b, got_generic = _both_records(rec, w, x)
    assert tuple(got_b.shape) == want.shape
    assert rel_err(got_b, want) < 1e-5
    assert rel_err(got_generic, want) < 1e-5


@pytest.mark.parametrize("pads", [(1, 0, 0, 1), (0, 1, 1, 0), (1, 0, 1, 0),
                                  (0, 0, 1, 1)])
def test_pool_record_asymmetric_pads(pads):
    """A max-pool shard at a map edge pads -inf on its outward sides only
    (the resnet stem pool under a spatial split)."""
    rng = np.random.default_rng(sum(pads))
    x = rng.standard_normal((7, 7, 4)).astype(np.float32) - 5.0
    h = 7 + pads[0] + pads[1]
    wd = 7 + pads[2] + pads[3]
    rec = (int(ConvT.POOL), 3, 2, pads, (0, 7, 0, 7), (0, 4))
    want, got_b, got_generic = _both_records(rec, None, x)
    assert tuple(got_b.shape) == want.shape == ((h - 3) // 2 + 1,
                                               (wd - 3) // 2 + 1, 4)
    assert rel_err(got_b, want) == 0.0
    assert rel_err(got_generic, want) == 0.0


def test_session_needs_card_unless_cpu_requested():
    g = EDGE_MODELS["bert"](**MODEL_TEST_KW["bert"])
    plan = Plan(((Scheme.OUTC, Mode.T),) * len(g))
    ws = init_weights(g, torch.Generator().manual_seed(0), "cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Session(g, ws, plan, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Session(g, ws, plan, 2, ExecConfig(backend="torch"))
    out, _ = Session(g, ws, plan, 2, CPU).run(torch.zeros(16, 1, 32))
    assert out.device.type == "cpu"


def test_exec_config_validation():
    assert ExecConfig().device == "cuda" and ExecConfig().backend == "cuda"
    mesh = ExecConfig(executor="mesh")
    assert mesh.overlap and mesh.fallback == "raise" and not mesh.instrument
    with pytest.raises(ValueError, match="backend"):
        ExecConfig(backend="xla")
    with pytest.raises(ValueError, match="executor"):
        ExecConfig(executor="remote")
    with pytest.raises(RuntimeError):
        ExecConfig(device="tpu:0")
    g = EDGE_MODELS["bert"](**MODEL_TEST_KW["bert"])
    with pytest.raises(ValueError, match="nodes"):
        Session(g, [], Plan(((Scheme.INH, Mode.T),) * len(g)), 0, CPU)


@pytest.mark.parametrize("name", sorted(J_MODELS))
def test_weights_match_reference_layout(name):
    """init_weights draws the reference's shapes and scales from a torch
    Generator; weights_from_numpy takes the reference's arrays and rejects
    mis-shaped ones."""
    gj, wj, gt, wt, _ = model(name)
    gen = torch.Generator().manual_seed(1)
    mine = init_weights(gt, gen, "cpu")
    for a, b, c in zip(wj, mine, wt):
        assert (a is None) == (b is None) == (c is None)
        if a is not None:
            assert tuple(b.shape) == a.shape == tuple(c.shape)
            assert b.dtype == c.dtype == torch.float32
            np.testing.assert_array_equal(c.numpy(), np.asarray(a))
    big = [w for w in mine if w is not None and w.numel() >= 4096]
    for w in big:   # unit normal over sqrt(fan-in)
        fan_in = w.shape[0] if w.dim() == 2 else \
            w.shape[0] * w.shape[1] * w.shape[2]
        assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.1
    bad = [None if w is None else np.asarray(w) for w in wj]
    i = next(i for i, w in enumerate(bad) if w is not None)
    bad[i] = bad[i][..., :-1]
    with pytest.raises(ValueError, match="weight shape"):
        weights_from_numpy(gt, bad, "cpu")
    with pytest.raises(ValueError, match="weight arrays"):
        weights_from_numpy(gt, bad[:-1], "cpu")
