"""The half-precision cases of the port against the reference on the
CPU, shared by ``test_torch_half.py``, ``test_torch_half_pairs.py`` and
``test_torch_half_session.py``.

Kernels (:func:`check_conv`, :data:`PAIRS`): the port's wrappers run
their plain versions on CPU tensors, which read every element as f32,
sum in f32 and round once to ``x.dtype``, as the Pallas kernels in
interpret mode do; each output is held to the reference's within one ulp
of the output dtype, element by element (``torch_ulps.holds_one_ulp``),
and its dtype to the reference's.

Sessions (:func:`check_bf16_session`):
Both packages get the reference's weights rounded to bf16 (the port's
carried by ``weights_from_numpy(..., dtype=torch.bfloat16)``), the same
bf16 input and the same searched plan.  The port's ``backend="cuda"``
(its kernels' plain versions on CPU tensors), local and on the mesh, is
held against the reference's ``"pallas"`` (interpret mode), its
``"torch"`` against the reference's ``"xla"``: within the reference's
bf16 tolerance, 2e-2 of the output scale, and ``ExecStats`` equal field
for field (the reference counts 4 bytes a value in bf16 too).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.edge_models import EDGE_MODELS as J_MODELS
from repro.core import AnalyticEstimator as JEstimator
from repro.core import Testbed as JTestbed
from repro.core.dpp import plan_search as j_plan_search
from repro.kernels.conv2d import conv2d_shard as j_conv2d_shard
from repro.runtime.engine import init_weights as j_init_weights
from repro.runtime.session import ExecConfig as JExecConfig
from repro.runtime.session import Session as JSession

from repro_torch import (ExecConfig, Mode, Plan, Scheme, Session,
                         weights_from_numpy)
from repro_torch.configs.edge_models import EDGE_MODELS
from repro_torch.kernels.conv2d import conv2d_shard
from repro_torch.kernels.ref import conv2d_shard_ref

from torch_conformance import geometry_fields, rel_err
from torch_ulps import holds_one_ulp

BF16_TOL = 2e-2     # the reference's bf16 tolerance (tests/test_kernels.py)
#: model -> (constructor kwargs, nodes): ResNet-18 for its ADD merges,
#: bert-base at full width and 2 of its 12 layers
MODELS = {"mobilenet": (dict(width=32), 2),
          "resnet18": (dict(width=32), 3),
          "bert": (dict(n_layers=2), 2)}
#: (model, the port's backend, executor); "weights" checks the carried
#: weights alone
SESSION_CASES = tuple((name, backend, executor) for name in MODELS
                      for backend, executor in (
                          ("weights", "-"), ("cuda", "local"),
                          ("cuda", "mesh"), ("torch", "local")))


def to_torch(a) -> torch.Tensor:
    """A JAX or numpy array as a tensor of its dtype, bit for bit (through
    f32, which holds every bf16 and fp16 value)."""
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))
                            ).to(getattr(torch, str(a.dtype)))


#: (x dtype, w dtype): the kernel's own pairs, then two it reaches through
#: an exact upcast of the weight to f32
PAIRS = (("bfloat16", "bfloat16"), ("float16", "float16"),
         ("bfloat16", "float32"), ("float16", "float32"),
         ("float32", "bfloat16"), ("bfloat16", "float16"))
PAIR_IDS = [f"{a}-{b}" for a, b in PAIRS]


def operands(rng, shape, dtype, scale=1.0):
    """A random array rounded to ``dtype``: the JAX array and the port's
    tensor of the same values."""
    a = jnp.asarray(rng.standard_normal(shape) * scale, jnp.float32)
    j = a.astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def check_conv(xd, wd, k, s, pads, depthwise, seed, cin=16, cout=24):
    """One shard: the port's wrapper on a strided view and a contiguous
    input, with an OutC view of a wider weight (dense), against the Pallas
    kernel in interpret mode on the same values."""
    rng = np.random.default_rng(seed)
    wshape = (k, k, 1, cin) if depthwise else (k, k, cin, cout + 4)
    wj, wt = operands(rng, wshape, wd, 0.3)
    if not depthwise:
        wj, wt = wj[..., 2:2 + cout], wt[..., 2:2 + cout]
    h = k + 3 * s + 1 - pads[0] - pads[1]
    wdt = k + 3 * s + 2 - pads[2] - pads[3]
    bj, bt = operands(rng, (h + 2, wdt + 1, cin + 3), xd)
    xj, view = bj[1:1 + h, :wdt, 2:2 + cin], bt[1:1 + h, :wdt, 2:2 + cin]
    ref = j_conv2d_shard(xj, wj, pads=pads, stride=s, depthwise=depthwise,
                         tile_h=2)
    want = to_torch(ref)
    for xt in (view, view.contiguous()):
        out = conv2d_shard(xt, wt, pads=pads, stride=s, depthwise=depthwise)
        assert out.dtype == want.dtype
        mag = conv2d_shard_ref(xt.float().abs(), wt.float().abs(),
                               pads=pads, stride=s, depthwise=depthwise)
        holds_one_ulp(out, want, mag)



@functools.lru_cache(maxsize=None)
def bf16_model(name):
    """Both packages' graph, bf16 weights, bf16 input and plan."""
    kw, nodes = MODELS[name]
    gj = J_MODELS[name](**kw)
    gt = EDGE_MODELS[name](**kw)
    wj = [None if w is None else w.astype(jnp.bfloat16)
          for w in j_init_weights(gj, jax.random.PRNGKey(0))]
    wt = weights_from_numpy(gt, [None if w is None else np.asarray(w)
                                 for w in wj], "cpu", dtype=torch.bfloat16)
    l0 = gj.layers[0]
    xj = jnp.asarray(np.random.default_rng(0).standard_normal(
        (l0.in_h, l0.in_w, l0.in_c)), jnp.bfloat16)
    pj = j_plan_search(gj, JEstimator(),
                       JTestbed(nodes=nodes, bandwidth_gbps=0.5)).plan
    pt = Plan(tuple((Scheme(int(s)), Mode(int(m))) for s, m in pj.steps))
    return gj, wj, gt, wt, xj, to_torch(xj), pj, pt, nodes


@functools.lru_cache(maxsize=None)
def reference_run(name, backend):
    gj, wj, _, _, xj, _, pj, _, nodes = bf16_model(name)
    out, st = JSession(gj, wj, pj, nodes, JExecConfig(backend=backend)).run(
        xj)
    return to_torch(out), st


def check_bf16_session(name, backend, executor) -> None:
    gj, wj, gt, wt, xj, xt, pj, pt, nodes = bf16_model(name)
    if backend == "weights":
        for a, b in zip(wj, wt):
            assert (a is None) == (b is None)
            if a is not None:
                assert b.dtype == torch.bfloat16
                assert torch.equal(b, to_torch(a))
        return
    want, st_j = reference_run(name, "pallas" if backend == "cuda"
                               else "xla")
    cfg = ExecConfig(backend=backend, executor=executor, device="cpu")
    out, st = Session(gt, wt, pt, nodes, cfg).run(xt)
    assert out.dtype == torch.bfloat16 and out.shape == want.shape
    e = rel_err(out.float().numpy(), want.float().numpy())
    differ = int((out != want).sum())
    assert e < BF16_TOL, (f"{name} {backend} {executor}: {e:.3g} of scale "
                          f"from the reference; {differ} of {out.numel()} "
                          f"elements differ")
    assert geometry_fields(st) == geometry_fields(st_j)
    assert st.failure_count == 0
