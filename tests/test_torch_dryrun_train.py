"""The dry run of the ssm and hybrid train steps (``launch/op_cost.py``'s
loop fold under autograd) and of MoE's collectives, against the port's
own every-step count and against the JAX package.

* A folded train step (rwkv6 and zamba2 reduced, remat on, recurrent and
  chunked with a chunk that divides the sequence and one that does not)
  counts exactly what the same step counts with every step run: FLOPs,
  bytes and kernel units.  ``peak_bytes`` is printed, not held: the fold
  keeps fewer steps' tensors alive.
* Pair A of ``experiments/hillclimb.py``: the chunked form counts fewer
  bytes than the recurrent one, on the port (its counter) and on the
  reference (``analyze_hlo`` of ``jax.value_and_grad(model.loss)``).
* (The four production train combinations that were not counted before
  are in ``tests/test_torch_dryrun_production.py``.)
* MoE's collectives on a 2 x 4 mesh against the reference's compiled
  program, which runs in a subprocess over 8 host devices on an
  Auto-typed mesh (importing ``repro.launch.dryrun`` sets ``XLA_FLAGS``
  for the whole worker, and ``make_production_mesh`` gives Explicit axes
  on this JAX, which the reference's activation constraint rejects).

``python tests/test_torch_dryrun_train.py`` prints the port's counts over
the reference's for the reduced SSM train steps (the gap table of ROADMAP
A 7.4), and the MoE collectives of both packages: on the comparison's
step, at twice its batch, and on a data 4 x model 2 mesh.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import ShapeMesh, make_local_mesh
from repro_torch.launch.op_cost import OpCounter
from repro_torch.models.transformer import Model
from repro_torch.runtime.shard_plan import Strategy
from repro_torch.runtime.steps import loss_and_grads

from torch_lm_cases import one_intra_op_thread  # noqa: F401

SSM_ARCHS = ("rwkv6-3b", "zamba2-1.2b")
MOE_ARCHS = ("granite-moe-3b-a800m", "deepseek-v2-236b")
#: the MoE comparison's step: (seq, batch, mode) on a data 2 x model 4 mesh
MOE_SHAPE = (64, 8, "train")
#: the reference's all-to-all bytes a card, ep less tp, on that step (the
#: share of its expert dispatch; the dense olmo-1b moves 524,288 as well)
REF_DISPATCH = {"granite-moe-3b-a800m": 2_359_296,
                "deepseek-v2-236b": 1_048_576}


def _ssm_cfg(arch, chunk, dtype="float32"):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                            chunk=chunk))


# ---------------------------------------------------------------------------
# the fold against every step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [0, 4, 5])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_folded_train_count_equals_every_step(arch, chunk):
    """S 24: the recurrent loop folds 24 steps, chunk 4 six chunks (4
    divides 24), chunk 5 five (the last padded)."""
    cfg = _ssm_cfg(arch, chunk)
    counts = {}
    for fold in (False, True):
        with FakeTensorMode():
            model = Model(cfg, device="cpu")
            c, _, _, _ = dryrun.count_step(cfg, model, (24, 2, "train"),
                                           make_local_mesh(), Strategy(),
                                           fold_loops=fold)
        counts[fold] = c
    every, folded = counts[False], counts[True]
    assert (folded.flops, folded.bytes, folded.units) == \
        (every.flops, every.bytes, every.units)
    assert folded.flops > 0 and folded.bytes > 0
    want = {"flash_attention_bh": cfg.n_layers} if arch.startswith(
        "zamba2") else {}
    assert folded.units == want
    print(f"{arch} chunk {chunk}: peak_bytes every step "
          f"{every.peak_bytes}, folded {folded.peak_bytes}")


def test_fold_runs_four_steps_whatever_the_length():
    """Under the fold a recurrent loop runs 4 steps, so a train step of 16
    tokens and one of 32 make the same op calls; with every step run the
    longer one makes more."""
    cfg = _ssm_cfg("rwkv6-3b", 0)
    calls = {}
    for fold in (False, True):
        for seq in (16, 32):
            with FakeTensorMode():
                model = Model(cfg, device="cpu")
                c, _, _, _ = dryrun.count_step(
                    cfg, model, (seq, 2, "train"), make_local_mesh(),
                    Strategy(), fold_loops=fold)
            calls[fold, seq] = sum(n for n, _, _ in c.by_op.values())
    assert calls[True, 16] == calls[True, 32]
    assert calls[False, 32] > calls[False, 16] > calls[True, 16]


def test_torch_keeps_the_autograd_hooks_the_fold_reads():
    """The fold under autograd (ROADMAP A 7.4) knows a folded iteration's
    backward by three private hooks of torch: the next node's sequence
    number, the node running now, and that node's sequence number.  A
    torch without them, or with other numbers, fails here by name rather
    than changing the dry run's counts quietly."""
    hooks = {"torch.autograd._get_sequence_nr":
             getattr(torch.autograd, "_get_sequence_nr", None),
             "torch._C._current_autograd_node":
             getattr(torch._C, "_current_autograd_node", None)}
    missing = [n for n, f in hooks.items() if f is None]
    assert not missing, f"ROADMAP A 7.4: the loop fold needs {missing}"
    seen = []

    class Twice(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return 2 * x

        @staticmethod
        def backward(ctx, g):
            node = torch._C._current_autograd_node()
            seen.append(None if node is None else node._sequence_nr())
            return 2 * g

    lo = torch.autograd._get_sequence_nr()
    y = Twice.apply(torch.ones(3, requires_grad=True))
    hi = torch.autograd._get_sequence_nr()
    y.sum().backward()
    assert len(seen) == 1 and seen[0] is not None and lo <= seen[0] < hi, \
        (f"ROADMAP A 7.4: the node running a backward no longer carries "
         f"the sequence number it was made with ({lo}..{hi}: {seen})")


# ---------------------------------------------------------------------------
# pair A: chunked below recurrent in bytes, on both packages
# ---------------------------------------------------------------------------

PAIR_A = dict(batch=2, seq=32, chunk=8)


def port_counts(arch, chunk, batch=PAIR_A["batch"], seq=PAIR_A["seq"]):
    """FLOPs and bytes of the port's ``loss_and_grads`` (remat) on fake
    tensors, f32."""
    cfg = _ssm_cfg(arch, chunk)
    with FakeTensorMode():
        model = Model(cfg, device="cpu").requires_grad_(True)
        b = {k: torch.zeros((batch, seq), dtype=torch.int32)
             for k in ("tokens", "labels")}
        with OpCounter() as c:
            loss_and_grads(model, b)
    return c.flops, c.bytes


def ref_counts(arch, chunk, batch=PAIR_A["batch"], seq=PAIR_A["seq"]):
    """FLOPs and bytes of the reference's ``jax.value_and_grad(model.loss)``
    (remat) by ``analyze_hlo``, f32."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config as j_get_config
    from repro.launch.hlo_cost import analyze_hlo
    from repro.models.transformer import Model as JModel
    jc = dataclasses.replace(j_get_config(arch).reduced(), dtype="float32")
    jc = dataclasses.replace(jc, ssm=dataclasses.replace(jc.ssm, chunk=chunk))
    jm = JModel(jc)
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    b = {k: jax.ShapeDtypeStruct((batch, seq), jnp.int32)
         for k in ("tokens", "labels")}
    fn = jax.jit(jax.value_and_grad(lambda p, x: jm.loss(p, x)))
    tot = analyze_hlo(fn.lower(params, b).compile().as_text())
    return tot["flops"], tot["bytes"]


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_pair_a_chunked_counts_fewer_bytes_on_both_packages(arch):
    port = {c: port_counts(arch, c) for c in (0, PAIR_A["chunk"])}
    ref = {c: ref_counts(arch, c) for c in (0, PAIR_A["chunk"])}
    for counts in (port, ref):
        assert counts[PAIR_A["chunk"]][1] < counts[0][1]
    # the port counts the same model: FLOPs within 25% of the reference's
    for c in port:
        assert 0.75 < port[c][0] / ref[c][0] < 1.25, (c, port[c], ref[c])


# ---------------------------------------------------------------------------
# MoE's collectives against the reference
# ---------------------------------------------------------------------------

_REF_MOE = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from jax.sharding import AxisType
assert len(jax.devices()) == 8
import repro.launch.dryrun as D
from repro.configs.registry import get_config
from repro.launch.hlo_cost import analyze_hlo
from repro.models.transformer import Model
from repro.runtime.shard_ctx import activation_sharding, batch_shard_fn
from repro.runtime.shard_plan import Strategy, data_axes
seq, batch, mode = json.loads(sys.argv[2])
D.SHAPES["moe_case"] = (seq, batch, mode)
data = int(sys.argv[3])
mesh = jax.make_mesh((data, 8 // data), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
for arch in sys.argv[1].split(","):
    for moe in ("ep", "tp"):
        cfg = get_config(arch).reduced()
        args, in_sh, out_sh, step, _ = D.build_inputs(
            cfg, Model(cfg), "moe_case", mesh, Strategy(moe=moe))
        with mesh, activation_sharding(batch_shard_fn(mesh,
                                                      data_axes(mesh))):
            hlo = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh) \
                .lower(*args).compile().as_text()
        out[f"{arch}/{moe}"] = {k.split(":", 1)[1]: v for k, v in
                                analyze_hlo(hlo).items()
                                if k.startswith("coll:")}
print(json.dumps(out))
'''


def ref_moe_collectives(archs=MOE_ARCHS, shape=MOE_SHAPE, data=2) -> dict:
    """``"arch/ep|tp"`` -> the reference's collective bytes a card by kind,
    from its compiled step on the ``data`` x ``8 / data`` mesh."""
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(src), os.environ.get("PYTHONPATH", "")]))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _REF_MOE, ",".join(archs),
                          json.dumps(list(shape)), str(data)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def port_moe_records(archs=MOE_ARCHS, shape=MOE_SHAPE, data=2) -> dict:
    mesh = ShapeMesh({"data": data, "model": 8 // data})
    return {f"{a}/{moe}": dryrun.run_one(
        a, shape, strategy=Strategy(moe=moe), mesh=mesh,
        cfg_transform=lambda c: c.reduced(), verbose=False)
        for a in archs for moe in ("ep", "tp")}


def expert_buffer(arch, shape=MOE_SHAPE, data=2):
    """One reduced MoE layer's expert buffer [E, G·C, d] on a card, bf16,
    over the batch rows of ``data`` data shards (1: the global batch)."""
    cfg = get_config(arch).reduced()
    seq, batch, _ = shape
    m = cfg.moe
    cap = max(1, int(seq * m.top_k * m.capacity_factor / m.n_experts))
    return m.n_experts * (batch // data) * cap * cfg.d_model * 2


def test_moe_collectives_against_the_reference():
    """ep and tp differ, in the reference's order: tp's collectives take
    longer than ep's on both configs.  ep's all-to-all (dispatch and
    combine of the card's rows, one expert buffer each in the forward and
    the backward) is within 2x of the reference's dispatch share:
    measured 1.111x for granite-moe (2,621,440 against 2,359,296 bytes a
    card) and 1.250x for deepseek-v2 (1,310,720 against 1,048,576).  tp
    holds the global batch's buffer on every card, as the reference's
    compiled step does (``f32[4,320,128]``: all 8 rows' 40 slots): one
    all-gather over data and one all-reduce over model of it a pass."""
    ref = ref_moe_collectives()
    port = port_moe_records()
    fmt = {k: (v["coll_bytes"], v["t_collective_s"]) for k, v in port.items()}
    print(json.dumps({"reference": ref, "port": fmt}, default=str))
    for arch in MOE_ARCHS:
        ep, tp = port[f"{arch}/ep"], port[f"{arch}/tp"]
        assert ep["coll_bytes"] != tp["coll_bytes"]
        n_moe = cfg_moe_layers(arch)
        a2a = ep["coll_bytes"]["all-to-all"]
        assert a2a == 2 * 2 * n_moe * expert_buffer(arch)
        assert "all-to-all" not in tp["coll_bytes"]
        glob = 2 * n_moe * expert_buffer(arch, data=1)
        for kind in ("all-reduce", "all-gather"):
            assert tp["coll_bytes"][kind] - ep["coll_bytes"][kind] == glob
        share = ref[f"{arch}/ep"]["all-to-all"] \
            - ref[f"{arch}/tp"]["all-to-all"]
        assert share == REF_DISPATCH[arch]
        assert 0.5 < a2a / share < 2.0, (arch, a2a / share)
        # the order of the two strategies, on both packages
        assert sum(ref[f"{arch}/tp"].values()) > \
            sum(ref[f"{arch}/ep"].values())
        assert tp["t_collective_s"] > ep["t_collective_s"]


def cfg_moe_layers(arch) -> int:
    cfg = get_config(arch).reduced()
    return cfg.n_layers - cfg.moe.first_dense


def _gap_table():
    rows = []
    for arch in SSM_ARCHS:
        for chunk in (0, PAIR_A["chunk"]):
            (pf, pb), (rf, rb) = port_counts(arch, chunk), \
                ref_counts(arch, chunk)
            rows.append((arch, chunk, pf / rf, pb / rb, pb, rb))
    print("arch chunk port/ref_flops port/ref_bytes port_bytes ref_bytes")
    for r in rows:
        print(f"{r[0]} {r[1]} {r[2]:.3f} {r[3]:.3f} {r[4]:.0f} {r[5]:.0f}")
    for arch in SSM_ARCHS:
        rec = {c: r[2:] for a, c, *r in rows if a == arch}
        print(f"{arch}: recurrent over chunked bytes, port "
              f"{rec[0][0] / rec[8][0]:.2f}x, reference "
              f"{rec[0][1] / rec[8][1]:.2f}x")


if __name__ == "__main__":
    torch.set_num_threads(1)
    _gap_table()
    # the comparison's step, a global batch twice as large, a mesh with
    # the data axis the larger one (granite-moe)
    for archs, shape, data in ((MOE_ARCHS, MOE_SHAPE, 2),
                               (MOE_ARCHS[:1], (64, 16, "train"), 2),
                               (MOE_ARCHS[:1], MOE_SHAPE, 4)):
        ref = ref_moe_collectives(archs, shape, data)
        for k, rec in port_moe_records(archs, shape, data).items():
            print(shape, f"data {data}", k, "port", rec["coll_bytes"],
                  rec["t_collective_s"], "reference", ref[k],
                  sum(ref[k].values()) / 50e9)
