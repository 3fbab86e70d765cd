"""The port's dry run (``launch/dryrun.py``) and its op counter
(``launch/op_cost.py``, the counterpart of the reference's
``launch/hlo_cost.py``), the roofline and the report, against the JAX
reference where the two compute the same thing.

* The counter's cases are ``tests/test_hlo_cost.py``'s: a loop of 23
  matmuls, nested loops, a batched einsum, an in-place slice write; then
  the kernel wrappers as one unit each, the SSM loops folded (their
  train steps in ``tests/test_torch_dryrun_train.py``), a real step
  against the same step on fake tensors,
  and a reduced llama3 forward against the reference's ``analyze_hlo`` of
  its jitted forward.
* The dry run's records pass ``tests/test_dryrun.py``'s assertions.
* ``model_flops_estimate``, ``Roofline.row()`` and the report tables
  equal the reference's on the same inputs.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.launch import report as jreport
from repro.launch.hlo_cost import analyze_hlo
from repro.launch.roofline import Roofline as JRoofline
from repro.launch.roofline import model_flops_estimate as j_model_flops

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch import dryrun, report
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.op_cost import OpCounter, attention_pairs
from repro_torch.launch.roofline import Roofline, model_flops_estimate
from repro_torch.models.transformer import Model
from repro_torch.runtime import shard_ctx
from repro_torch.runtime.shard_plan import Strategy

from torch_lm_cases import (carried, configs,  # noqa: F401
                            one_intra_op_thread, ref_dryrun_shapes)

# the package attribute of that name is ops.flash_attention, a function
fa = importlib.import_module("repro_torch.kernels.flash_attention")

#: the port's counted FLOPs of a reduced forward against the reference's
#: ``analyze_hlo``: the matmuls agree exactly; the elementwise work is
#: counted per op here and per fusion there (measured 1.3-2.1% apart)
HLO_FLOPS_TOL = 0.05


# ---------------------------------------------------------------------------
# The counter: tests/test_hlo_cost.py's cases
# ---------------------------------------------------------------------------

def test_loop_of_matmuls_counts_every_iteration():
    w, x = torch.zeros(64, 64), torch.zeros(64, 64)
    with OpCounter() as c:
        for _ in range(23):
            x = x @ w
    assert c.flops == 2 * 64 ** 3 * 23


def test_nested_loops_multiply():
    x = torch.zeros(32, 32)
    with OpCounter() as c:
        c_ = x
        for _ in range(3):
            for _ in range(5):
                c_ = c_ @ x
    assert c.flops == 2 * 32 ** 3 * 15


def test_batched_einsum_is_counted():
    a, b = torch.zeros(4, 32, 16), torch.zeros(4, 16, 8)
    with OpCounter() as c:
        torch.einsum("bij,bjk->bik", a, b)
    assert c.flops == 2 * 4 * 32 * 16 * 8


@pytest.mark.parametrize("how", ["slice", "index_put_", "index_copy_"])
def test_in_place_slice_write_counts_the_slice(how):
    big, upd = torch.zeros(4096, 1024), torch.ones(1, 1024)
    idx = torch.tensor([17])
    with OpCounter() as c:
        if how == "slice":
            big[17:18] = upd
        elif how == "index_put_":
            big.index_put_((idx,), upd)
        else:
            big.index_copy_(0, idx, upd)
    assert c.ops == 1
    # read the update, write the slice (and read the index)
    assert 2 * upd.numel() * 4 <= c.bytes <= 2 * upd.numel() * 4 + 8
    assert c.bytes < big.numel() * 4 * 0.5


def test_views_count_nothing_and_rows_read_by_index():
    t = torch.zeros(1000, 64)
    with OpCounter() as c:
        t.view(64, 1000).transpose(0, 1)[3:7]
    assert (c.ops, c.flops, c.bytes) == (0, 0, 0)
    with OpCounter() as c:
        t[torch.tensor([1, 2, 3])]
    assert c.bytes == 2 * 3 * 64 * 4 + 3 * 8 and c.flops == 0


# ---------------------------------------------------------------------------
# The kernels as units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,lse", [(True, None, False),
                                               (True, 5, True),
                                               (False, None, False)])
def test_flash_wrapper_is_one_unit(causal, window, lse):
    g = torch.Generator().manual_seed(0)
    B, H, KV, S, hd = 2, 4, 2, 24, 16
    q = torch.randn(B, H, S, hd, generator=g)
    k, v = (torch.randn(B, KV, S, hd, generator=g) for _ in range(2))
    want = fa.attention(q, k, v, causal=causal, window=window, scale=None,
                        return_lse=lse)
    with OpCounter() as c:
        got = fa.attention(q, k, v, causal=causal, window=window,
                           scale=None, return_lse=lse)
    assert c.units == {"flash_attention_bh": 1} and c.ops == 0
    for a, b in zip(got if lse else [got], want if lse else [want]):
        assert torch.equal(a, b)
    pairs = attention_pairs(S, causal, window)
    assert c.flops == 4 * B * H * pairs * hd
    assert c.bytes == 4 * (3 * q.numel() if KV == H else
                           2 * q.numel() + 2 * k.numel()) \
        + (4 * B * H * S if lse else 0)


@pytest.mark.parametrize("kv_len,window", [(37, None), (64, 20), (1, None)])
def test_decode_wrapper_is_one_unit(kv_len, window):
    g = torch.Generator().manual_seed(1)
    rows, groups, n_pages, ps, hd = 3, 2, 8, 8, 16
    q = torch.randn(rows * groups, hd, generator=g)
    kp, vp = (torch.randn(rows, n_pages, ps, hd, generator=g)
              for _ in range(2))
    table = torch.arange(n_pages, dtype=torch.int32)
    want = fa.flash_decode_paged(q, kp, vp, table, kv_len, window=window,
                                 groups=groups)
    with OpCounter() as c:
        got = fa.flash_decode_paged(q, kp, vp, table, kv_len, window=window,
                                    groups=groups)
    assert torch.equal(got, want)
    assert c.units == {"flash_decode_paged": 1} and c.ops == 0
    keys = min(kv_len, window) if window else kv_len
    assert c.flops == 4 * rows * groups * keys * hd
    lo = 0 if window is None else max(0, (kv_len - window) // ps)
    hi = -(-kv_len // ps)
    assert c.bytes == 2 * q.numel() * 4 + (hi - lo) * (
        2 * rows * ps * hd * 4 + 4)


# ---------------------------------------------------------------------------
# The SSM loops, and a step on real tensors against fake ones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,chunk", [("rwkv6-3b", 0), ("rwkv6-3b", 4),
                                        ("zamba2-1.2b", 0),
                                        ("zamba2-1.2b", 4)])
def test_ssm_loops_counted_once_times_trip_count(arch, chunk):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                           chunk=chunk))
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tok = torch.zeros((2, 16), dtype=torch.int32)
    counts = []
    for fold in (False, True):
        with torch.no_grad(), OpCounter(fold_loops=fold) as c:
            out = model.forward({"tokens": tok})[0]
        counts.append((c.flops, c.bytes, c.units))
        assert out.shape == (2, 16, cfg.vocab)
    assert counts[0] == counts[1]


def test_folded_loop_under_autograd_counts():
    """The fold covers the backward (ROADMAP A 7.4): a counted SSM train
    step with the loops folded counts what the same step counts with
    every step run (the production combinations in
    ``tests/test_torch_dryrun_train.py``)."""
    cfg = dataclasses.replace(get_config("rwkv6-3b").reduced(),
                              dtype="float32")
    counts = []
    for fold in (False, True):
        model = Model(cfg, device="cpu")
        c, _, _, _ = dryrun.count_step(cfg, model, (16, 2, "train"),
                                       make_local_mesh(), Strategy(),
                                       fold_loops=fold)
        counts.append((c.flops, c.bytes, c.units))
    assert counts[0] == counts[1]


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_real_step_counts_equal_fake_step_counts(mode):
    """What chip_smoke's phase 16b holds on the card, on CPU tensors at a
    reduced size: the step run on real tensors and on fake ones counts the
    same FLOPs, bytes and kernel units, on the one-card mesh."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              dtype="float32")
    mesh = make_local_mesh()
    shape = (24, 2, mode)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    real, inputs, _, _ = dryrun.count_step(cfg, model, shape, mesh,
                                           Strategy())
    live_args = dryrun.argument_bytes(inputs, mesh)
    with FakeTensorMode():
        fmodel = Model(cfg, device="cpu")
        fake, finputs, _, _ = dryrun.count_step(cfg, fmodel, shape, mesh,
                                                Strategy())
        fake_args = dryrun.argument_bytes(finputs, mesh)
    assert (real.flops, real.bytes, real.units) == (fake.flops, fake.bytes,
                                                    fake.units)
    assert real.units == {"flash_decode_paged" if mode == "decode"
                          else "flash_attention_bh":
                          cfg.n_layers * (2 if mode == "train" else 1)}
    assert live_args == fake_args == sum(
        t.numel() * t.element_size() for t in {
            id(t): t for t in _leaves(inputs.args)}.values())


def _leaves(tree):
    from repro_torch.runtime.shard_plan import tree_leaves
    return tree_leaves(tree)


def test_reduced_forward_flops_match_analyze_hlo():
    """A reduced llama3 forward in f32: the port's count against the
    reference's ``analyze_hlo`` of its jitted forward, after aligning the
    attention convention (the reference's short-sequence ``_sdpa`` scores
    every (query, key) pair; the flash unit counts the causal ones)."""
    jc, pc = configs("llama3-8b")
    jm, params, tm = carried(jc, pc)
    B, S = 2, 64
    tok = np.zeros((B, S), np.int32)
    fwd = jax.jit(lambda p, t: jm.forward(p, {"tokens": t})[0])
    ref = analyze_hlo(fwd.lower(params, jnp.asarray(tok)).compile()
                      .as_text())
    with torch.no_grad(), OpCounter() as c:
        tm.forward({"tokens": torch.from_numpy(tok)})
    assert c.units == {"flash_attention_bh": pc.n_layers}
    per_pair = 4.0 * B * pc.n_heads * pc.hd * pc.n_layers
    ours = c.flops + per_pair * (S * S - attention_pairs(S, True, None))
    assert abs(ours - ref["flops"]) / ref["flops"] < HLO_FLOPS_TOL


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------

def _record_ok(rec):
    """``tests/test_dryrun.py``'s assertions on a record."""
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert 0 < rec["useful_ratio"] < 10
    assert rec["mem_per_device"]["temp_size_bytes"] is not None


def test_dryrun_record_pipeline():
    assert dryrun.SHAPES == ref_dryrun_shapes()
    rec = dryrun.run_one("olmo-1b", "decode_32k", verbose=False)
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    _record_ok(rec)
    # decode reads weights + KV every token -> memory-bound
    assert rec["bottleneck"] == "memory"
    assert rec["kernel_units"] == {"flash_decode_paged": 16}
    # the cache dominates: B 128 x 16 KV heads x 32768 x hd 128, K and V,
    # bf16, 16 layers, over 256 cards; the TP-resident weights over 16
    cache = 128 * 16 * 32768 * 128 * 2 * 2 * 16 / 256
    args = rec["mem_per_device"]["argument_size_bytes"]
    assert cache < args < cache + 2 * 1.18e9 / 16 * 1.01


def test_dryrun_multipod_and_relayouts():
    """The multi-pod mesh, and the re-layout points a prefill records:
    n_layers + 1 of them, each the callback's target spec."""
    cfg = get_config("olmo-1b")
    rec = dryrun.run_one("olmo-1b", (2048, 64, "prefill"), multi_pod=True,
                         verbose=False)
    assert rec["mesh"] == "2x16x16" and rec["chips"] == 512
    _record_ok(rec)
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh()
    with FakeTensorMode():
        model = Model(cfg, device=dryrun.fake_device())
        c, _, _, sp = dryrun.count_step(cfg, model, (2048, 32, "prefill"),
                                        mesh, Strategy(attn="sp"))
    assert sp and len(c.relayouts) == cfg.n_layers + 1
    assert {spec for _, spec in c.relayouts} == {("data", "model", None)}


def test_constrain_points_and_identity():
    """A recording callback sees every re-layout point (each block's entry
    and each stack's end); the forward's bits do not change."""
    for arch in ("llama3-8b", "deepseek-v2-236b", "zamba2-1.2b",
                 "whisper-small"):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32")
        model = Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32)}
        if cfg.family == "encdec":
            batch["audio_embeds"] = torch.zeros((2, cfg.enc_seq,
                                                 cfg.d_model))
        seen = []

        def record(x):
            seen.append(tuple(x.shape))
            return x
        with torch.no_grad():
            plain = model.forward(batch)[0]
            with shard_ctx.activation_sharding(record):
                traced = model.forward(batch)[0]
        assert torch.equal(plain, traced)
        if cfg.family == "dense":
            want = cfg.n_layers + 1
        elif cfg.family == "moe":
            fd = cfg.moe.first_dense
            want = (fd + 1 if fd else 0) + (cfg.n_layers - fd) + 1
        elif cfg.family == "hybrid":
            every = cfg.hybrid_attn_every or cfg.n_layers
            want = cfg.n_layers + -(-cfg.n_layers // every)
        else:
            want = (cfg.n_enc_layers + 1) + (cfg.n_layers + 1)
        assert len(seen) == want, (arch, seen)


# ---------------------------------------------------------------------------
# Roofline and report against the reference
# ---------------------------------------------------------------------------

def test_model_flops_estimate_equals_reference():
    for arch in ARCH_IDS:
        for shape, (seq, batch, mode) in dryrun.SHAPES.items():
            cfg = dryrun.arch_for_shape(arch, shape)
            jcfg = j_get_config(arch)
            if cfg.attn_window != jcfg.attn_window:
                jcfg = dataclasses.replace(jcfg, attn_window=cfg.attn_window)
            assert model_flops_estimate(cfg, seq, batch, mode) == \
                j_model_flops(jcfg, seq, batch, mode)


def _records():
    recs = []
    for i, (arch, shape, mesh, chips) in enumerate(
            [("olmo-1b", "decode_32k", "16x16", 256),
             ("llama3-8b", "train_4k", "16x16", 256),
             ("llama3-8b", "train_4k", "2x16x16", 512),
             ("zamba2-1.2b", "prefill_32k", "16x16", 256)]):
        kw = dict(arch=arch, shape=shape, mesh=mesh, chips=chips,
                  hlo_flops=1.5e12 * (i + 1), hlo_bytes=3.1e10 / (i + 1),
                  coll_bytes={"all-gather": 2.5e9 * i, "all-reduce": 7e5},
                  model_flops=2e14 * (i + 1), peak_flops=989e12,
                  hbm_bw=3.35e12)
        ours = Roofline(link_bw=50e9, **kw).row()
        theirs = JRoofline(ici_bw=50e9, **kw).row()
        assert ours == theirs
        ours.update({"compile_s": 1.5 * i, "mem_per_device": {
            "argument_size_bytes": 3e9 * i, "temp_size_bytes": 1e8 * i}})
        recs.append(ours)
    return recs


def test_roofline_rows_and_report_tables_equal_reference():
    recs = _records()
    rec = dryrun.run_one("olmo-1b", "decode_32k", verbose=False)
    recs.append(rec)
    assert report.dryrun_table(recs) == jreport.dryrun_table(recs)
    assert report.roofline_table(recs) == jreport.roofline_table(recs)
