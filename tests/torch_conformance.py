"""Shared pieces of the port-vs-reference conformance tests
(``tests/test_torch_*.py``): the reference's test-scale model sizes, its
scale-normalised error, the conv-shard grid check and the engine
comparisons (local and mesh executor)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.edge_models import EDGE_MODELS as J_MODELS
from repro.core import AnalyticEstimator as JEstimator
from repro.core import Testbed as JTestbed
from repro.core.dpp import plan_search as j_plan_search
from repro.core.graph import ConvT as JConvT
from repro.core.partition import Mode as JMode
from repro.core.partition import Scheme as JScheme
from repro.core.plan import Plan as JPlan
from repro.runtime.engine import init_weights as j_init_weights
from repro.runtime.engine import run_reference as j_run_reference
from repro.runtime.session import ExecConfig as JExecConfig
from repro.runtime.session import Session as JSession

from repro.kernels.conv2d import conv2d_shard as j_conv2d_shard
from repro.kernels.ref import conv2d_shard_ref as j_conv2d_shard_ref

from repro_torch import (ExecConfig, Mode, Plan, Scheme, Session,
                         run_reference, weights_from_numpy)
from repro_torch.configs.edge_models import EDGE_MODELS
from repro_torch.core.graph import ConvT, conv_geometries, shard_halo_pads
from repro_torch.kernels.conv2d import conv2d_shard

#: the reference's test-scale constructor kwargs
#: (tests/test_kernel_conformance.py MODEL_TEST_KW)
MODEL_TEST_KW = {
    "mobilenet": dict(width=32),
    "resnet18": dict(width=32),
    "resnet101": dict(width=32),
    "inception": dict(width=32),
    "bert": dict(seq=16, d=32, n_layers=1, d_ff=64),
}
_CONV_TYPES = (ConvT.CONV, ConvT.DWCONV, ConvT.POINTWISE)


def _conv_geoms():
    geoms = set()
    for name, f in EDGE_MODELS.items():
        geoms.update(conv_geometries(f()))
        geoms.update(conv_geometries(f(**MODEL_TEST_KW[name])))
    return sorted(g for g in geoms if g[0] in _CONV_TYPES)


CONV_GEOMS = _conv_geoms()


def geom_id(g) -> str:
    t, k, s, p = g
    return f"{t.name}-k{k}-s{s}-p{p}"


def rel_err(a, b) -> float:
    """Max abs deviation normalized by the reference scale (the reference's
    tests/test_kernel_conformance.py::rel_err, on numpy arrays)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    if a.size == 0:
        return 0.0
    scale = max(1.0, float(np.max(np.abs(b))))
    return float(np.max(np.abs(a - b))) / scale


def strided_view(a: np.ndarray) -> torch.Tensor:
    """``a`` as a non-contiguous torch view (row/column strides of a larger
    buffer, channel stride 1) — the engine's halo-slice layout."""
    h, w, c = a.shape
    big = torch.zeros((h + 3, w + 2, c + 5), dtype=torch.float32)
    view = big[2:2 + h, 1:1 + w, 3:3 + c]
    view.copy_(torch.from_numpy(a))
    assert not view.is_contiguous() and view.stride(2) == 1
    return view


def check_conv_grid(t, k, s, p) -> None:
    """Every shard zero-pad signature of geometry ``(t, k, s, p)``: the
    port's conv2d_shard on CPU tensors (contiguous and strided-view
    inputs, and a channel-sliced weight view) equals the Pallas kernel in
    interpret mode, on the reference's grid shapes."""
    rng = np.random.default_rng(k * 100 + s * 10 + p)
    cin = 5
    cout = cin if t == ConvT.DWCONV else 7
    dw = t == ConvT.DWCONV
    wshape = (k, k, 1, cin) if dw else (k, k, cin, cout)
    w = (rng.standard_normal(wshape) * 0.2).astype(np.float32)
    for pads in shard_halo_pads(p):
        h = k + 3 * s + 1 - pads[0] - pads[1]
        wdt = k + 3 * s + 1 - pads[2] - pads[3]
        x = rng.standard_normal((h, wdt, cin)).astype(np.float32)
        ref = j_conv2d_shard(jnp.asarray(x), jnp.asarray(w), pads=pads,
                             stride=s, depthwise=dw, tile_h=2)
        assert rel_err(ref, j_conv2d_shard_ref(
            jnp.asarray(x), jnp.asarray(w), pads=pads, stride=s,
            depthwise=dw)) < 1e-4
        wt = torch.from_numpy(w)
        if not dw:   # an OutC shard's weight: a view of a wider tensor
            wide = torch.zeros(wshape[:3] + (cout + 4,))
            wide[..., 2:2 + cout] = wt
            wt = wide[..., 2:2 + cout]
        for xt in (torch.from_numpy(x), strided_view(x)):
            out = conv2d_shard(xt, wt, pads=pads, stride=s, depthwise=dw)
            assert tuple(out.shape) == ref.shape
            assert rel_err(out, ref) < 1e-4, (pads,)


@functools.lru_cache(maxsize=None)
def model(name):
    """JAX graph + weights, the port's graph + the same weights, input."""
    gj = J_MODELS[name](**MODEL_TEST_KW[name])
    gt = EDGE_MODELS[name](**MODEL_TEST_KW[name])
    wj = j_init_weights(gj, jax.random.PRNGKey(0))
    wt = weights_from_numpy(
        gt, [None if w is None else np.asarray(w) for w in wj], "cpu")
    l0 = gj.layers[0]
    x = np.random.default_rng(0).standard_normal(
        (l0.in_h, l0.in_w, l0.in_c)).astype(np.float32)
    return gj, wj, gt, wt, x


def plans(gj, kind):
    """(JAX plan, port plan, nodes) for one plan kind."""
    if kind == "grid2d-n3":
        # GRID2D on every spatial layer; FC layers (seq x 1 maps, which a
        # 2-D grid would cut into empty columns the reference cannot run)
        # take OutC, exercising the plan's weight column slices
        pj = JPlan(tuple((JScheme.OUTC if l.conv_t == JConvT.FC
                          else JScheme.GRID2D, JMode.T) for l in gj.layers))
        nodes = 3
    else:
        nodes = int(kind[-1])
        pj = j_plan_search(gj, JEstimator(),
                           JTestbed(nodes=nodes, bandwidth_gbps=0.5)).plan
    pt = Plan(tuple((Scheme(int(s)), Mode(int(m))) for s, m in pj.steps))
    return pj, pt, nodes


def geometry_fields(stats):
    return {f.name: getattr(stats, f.name)
            for f in dataclasses.fields(stats) if f.compare}


PLANS = ("search-n2", "search-n4", "grid2d-n3")


def check_session(name, kind) -> None:
    """The JAX ``Session`` (backend "xla") and the port's, on CPU tensors
    under both backends, on the same plan, weights and input: outputs
    within 1e-4 of the output scale, ``ExecStats`` geometry equal."""
    gj, wj, gt, wt, x = model(name)
    pj, pt, nodes = plans(gj, kind)
    out_j, st_j = JSession(gj, wj, pj, nodes,
                           JExecConfig(backend="xla")).run(x)
    want = geometry_fields(st_j)
    assert set(want) == {"sync_points", "bytes_received",
                         "redundant_elems", "compute_stages"}
    for backend in ("torch", "cuda"):
        cfg = ExecConfig(backend=backend, device="cpu")
        out, st = Session(gt, wt, pt, nodes, cfg).run(torch.from_numpy(x))
        assert tuple(out.shape) == out_j.shape
        assert rel_err(out, out_j) < 1e-4, backend
        assert geometry_fields(st) == want, backend


#: the mesh executor's plan kinds: searched plans at 2, 4 and 8 nodes and
#: the 3-node GRID2D plan
MESH_PLANS = ("search-n2", "search-n4", "search-n8", "grid2d-n3")


def check_mesh(name, kind) -> None:
    """The port's mesh executor on CPU tensors, under both backends and
    with the halo overlap on (and off, under "cuda"), against the JAX
    local ``Session`` (backend "xla") and the port's local executor on the
    same plan, weights and input: outputs within 1e-4 of the output
    scale, ``ExecStats`` equal, no fault counted."""
    gj, wj, gt, wt, x = model(name)
    pj, pt, nodes = plans(gj, kind)
    out_j, st_j = JSession(gj, wj, pj, nodes,
                           JExecConfig(backend="xla")).run(x)
    xt = torch.from_numpy(x)
    local, st_l = Session(gt, wt, pt, nodes, ExecConfig(
        backend="cuda", device="cpu")).run(xt)
    for backend, overlap in (("torch", True), ("cuda", True),
                             ("cuda", False)):
        sess = Session(gt, wt, pt, nodes, ExecConfig(
            backend=backend, executor="mesh", overlap=overlap,
            device="cpu"))
        assert sess.mesh.shape == {"nodes": nodes}
        out, st = sess.run(xt)
        assert tuple(out.shape) == out_j.shape
        assert rel_err(out, out_j) < 1e-4, (backend, overlap)
        assert rel_err(out, local) < 1e-4, (backend, overlap)
        assert geometry_fields(st) == geometry_fields(st_j)
        assert st == st_l and st.failure_count == 0


def check_run_reference(name) -> None:
    gj, wj, gt, wt, x = model(name)
    ref_j = j_run_reference(gj, wj, x)
    ref_t = run_reference(gt, wt, torch.from_numpy(x))
    assert rel_err(ref_t, ref_j) < 1e-4


def check_segment_programs(name, backend) -> None:
    """One model at the reference's test size under a searched 4-node
    plan: the port's segment programs (``jit_segments=True``, two runs)
    give the eager records' bits and ExecStats, and agree with the JAX
    Session (its segment cache on) within 1e-4 of the output scale."""
    gj, wj, gt, wt, x = model(name)
    pj, pt, nodes = plans(gj, "search-n4")
    xt = torch.from_numpy(x)
    out_j, st_j = JSession(gj, wj, pj, nodes).run(x)
    eager, st_e = Session(gt, wt, pt, nodes,
                          ExecConfig(backend=backend, jit_segments=False,
                                     device="cpu")).run(xt)
    sess = Session(gt, wt, pt, nodes, ExecConfig(backend=backend,
                                                 device="cpu"))
    for _ in range(2):
        out, st = sess.run(xt)
        assert torch.equal(out, eager)
        assert st == st_e
    assert rel_err(out, out_j) < 1e-4
    assert geometry_fields(st) == geometry_fields(st_j)
