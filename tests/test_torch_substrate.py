"""The port's training substrate (``repro_torch.data``, ``optim``,
``checkpoint``, ``launch.train``) against the JAX package's, on the CPU.

The reference's own ``tests/test_substrate.py`` cases run on the port;
then the two packages side by side: the schedule step by step, the data
pipeline's batches bit for bit, ``make_batch_specs`` on the ``meta``
device, checkpoints written by each package read by the other (and the
``params_to_numpy`` round trip), the masked cross-entropy, serving that
builds no autograd graph, and the training launcher on ``--device cpu``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as j_load_pytree
from repro.checkpoint import save_pytree as j_save_pytree
from repro.data import SyntheticLMDataset as JDataset
from repro.data import make_batch_specs as j_make_batch_specs
from repro.models.common import cross_entropy as j_cross_entropy
from repro.models.transformer import Model as JModel
from repro.optim import cosine_schedule as j_cosine_schedule

from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.configs.registry import get_config
from repro_torch.data import SyntheticLMDataset, make_batch_specs
from repro_torch.launch import serve, train
from repro_torch.models.common import cross_entropy
from repro_torch.models.transformer import (Model, params_from_numpy,
                                            params_to_numpy)
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule

from torch_lm_cases import (carried, configs,  # noqa: F401
                            one_intra_op_thread, to_numpy)


# ---------------------------------------------------------------------------
# The reference's test_substrate.py cases on the port
# ---------------------------------------------------------------------------

def test_dataset_deterministic_and_seekable():
    ds = SyntheticLMDataset(vocab=128, seq_len=32, global_batch=8, seed=1)
    b0a, b0b, b1 = ds.batch(0), ds.batch(0), ds.batch(1)
    np.testing.assert_array_equal(b0a["tokens"], b0b["tokens"])
    assert not np.array_equal(b0a["tokens"], b1["tokens"])
    assert b0a["tokens"].shape == (8, 32)
    np.testing.assert_array_equal(b0a["tokens"][:, 1:], b0a["labels"][:, :-1])


def test_dataset_host_sharding_partitions_global_batch():
    h0 = SyntheticLMDataset(vocab=64, seq_len=8, global_batch=8, seed=2,
                            n_hosts=2, host_id=0)
    h1 = SyntheticLMDataset(vocab=64, seq_len=8, global_batch=8, seed=2,
                            n_hosts=2, host_id=1)
    assert h0.local_batch == h1.local_batch == 4
    assert not np.array_equal(h0.batch(0)["tokens"], h1.batch(0)["tokens"])
    with pytest.raises(ValueError, match="does not split"):
        SyntheticLMDataset(vocab=64, seq_len=8, global_batch=7, n_hosts=2)


def test_adamw_converges_on_quadratic():
    w = torch.tensor([5.0, -3.0], requires_grad=True)
    params = {"w": w}
    opt = adamw_init(params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(300):
        g = torch.autograd.grad(torch.sum((w - target) ** 2), w)[0]
        adamw_update({"w": g}, opt, params, lr=5e-2, weight_decay=0.0)
    assert float(torch.sum((w.detach() - target) ** 2)) < 1e-3
    assert int(opt["step"]) == 300 and opt["step"].dtype == torch.int32


def test_adamw_grad_clip_bounds_update():
    params = {"w": torch.zeros(3)}
    opt = adamw_init(params)
    adamw_update({"w": torch.full((3,), 1e9)}, opt, params, lr=1.0,
                 grad_clip=1.0, weight_decay=0.0)
    assert float(params["w"].abs().max()) < 10.0


def test_cosine_schedule_shape():
    assert float(cosine_schedule(torch.tensor(0, dtype=torch.int32),
                                 peak_lr=1.0, warmup=10, total=100)) == \
        pytest.approx(0.0)
    assert float(cosine_schedule(torch.tensor(10, dtype=torch.int32),
                                 peak_lr=1.0, warmup=10, total=100)) == \
        pytest.approx(1.0, abs=1e-3)
    end = float(cosine_schedule(torch.tensor(100, dtype=torch.int32),
                                peak_lr=1.0, warmup=10, total=100,
                                floor=0.1))
    assert end == pytest.approx(0.1, abs=1e-3)


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3).float(),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16),
                  "d": [torch.zeros(2), torch.full((1,), 7.0)]}}
    p = str(tmp_path / "ckpt.npz")
    save_pytree(tree, p)
    out = load_pytree(tree, p)
    assert out["b"]["c"].dtype == torch.bfloat16
    assert isinstance(out["b"]["d"], list)
    for a, b in ((tree["a"], out["a"]), (tree["b"]["c"], out["b"]["c"]),
                 (tree["b"]["d"][1], out["b"]["d"][1])):
        assert torch.equal(a, b)


def test_checkpoint_shape_mismatch_raises(tmp_path):
    p = str(tmp_path / "c.npz")
    save_pytree({"a": torch.zeros(2)}, p)
    with pytest.raises(ValueError, match="shape mismatch for a"):
        load_pytree({"a": torch.zeros(3)}, p)
    with pytest.raises(KeyError, match="checkpoint missing b"):
        load_pytree({"b": torch.zeros(2)}, p)


# ---------------------------------------------------------------------------
# Side by side with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(0, 10), (1, 8), (10, 100),
                                          (100, 10_000)])
def test_schedule_matches_reference_step_by_step(warmup, total):
    kw = dict(peak_lr=3e-4, warmup=warmup, total=total, floor=0.1)
    for step in range(0, total + 5, max(1, total // 200)):
        want = float(j_cosine_schedule(jnp.int32(step), **kw))
        got_t = cosine_schedule(torch.tensor(step, dtype=torch.int32), **kw)
        got_i = cosine_schedule(step, **kw)
        assert got_t.dtype == torch.float32
        assert float(got_t) == pytest.approx(want, rel=1e-6, abs=1e-12)
        assert float(got_i) == pytest.approx(want, rel=1e-6, abs=1e-12)
    assert float(cosine_schedule(0, warmup=1)) == 0.0


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_batches_bit_equal_to_reference(seed, hosts):
    for host in range(hosts):
        kw = dict(vocab=1000, seq_len=33, global_batch=8, seed=seed,
                  n_hosts=hosts, host_id=host)
        mine, ref = SyntheticLMDataset(**kw), JDataset(**kw)
        for step in (0, 1, 5, 123):
            a, b = mine.batch(step), ref.batch(step)
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        for i, (a, b) in zip(range(3), zip(mine, ref)):
            np.testing.assert_array_equal(a["tokens"], b["tokens"])


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-vl-7b", "whisper-small"])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_batch_specs_match_reference(arch, mode):
    cfg = get_config(arch)
    ref = j_make_batch_specs(cfg, 128, 4, mode=mode)
    got = make_batch_specs(cfg, 128, 4, mode=mode)
    assert set(got) == set(ref)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(ref[k].shape)
        assert str(t.dtype).split(".")[-1] == str(ref[k].dtype)


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-3b-a800m",
                                  "zamba2-1.2b", "whisper-small"])
def test_checkpoints_cross_packages(arch, tmp_path):
    """A checkpoint of the reference's params loads into the port's
    ``params_to_numpy`` template and back into a model bit-equal; the
    port's checkpoint loads into the reference's template bit-equal; and
    ``params_from_numpy(params_to_numpy(m))`` is ``m``."""
    jc, pc = configs(arch)
    jm, params, pm = carried(jc, pc)
    ref_file, port_file = str(tmp_path / "ref.npz"), str(tmp_path / "p.npz")
    j_save_pytree(params, ref_file)
    tree = load_pytree(params_to_numpy(pm), ref_file)
    back = params_from_numpy(pc, tree, "cpu")
    for (n, a), (_, b) in zip(pm.named_parameters(),
                              back.named_parameters()):
        assert torch.equal(a, b), n

    save_pytree(params_to_numpy(pm), port_file)
    j_tree = j_load_pytree(params, port_file)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(j_tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jax.tree.structure(to_numpy(params)) == \
        jax.tree.structure(params_to_numpy(pm))


def test_bf16_checkpoint_saves_f32_and_loads_in_both(tmp_path):
    jc, pc = configs("llama3-8b", "bfloat16")
    jm, params, pm = carried(jc, pc)
    p = str(tmp_path / "bf16.npz")
    save_pytree({n: t for n, t in pm.named_parameters()}, p)
    with np.load(p) as d:
        assert {d[k].dtype for k in d.files} == {np.dtype(np.float32)}
    j_save_pytree(params, str(tmp_path / "j.npz"))
    tree = load_pytree(params_to_numpy(pm), str(tmp_path / "j.npz"))
    back = params_from_numpy(pc, tree, "cpu")
    for (n, a), (_, b) in zip(pm.named_parameters(),
                              back.named_parameters()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_mask_matches_reference(masked):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = float(j_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if mask is None else
                                 jnp.asarray(mask)))
    got = cross_entropy(torch.from_numpy(logits),
                        torch.from_numpy(labels).long(),
                        None if mask is None else torch.from_numpy(mask))
    assert float(got) == pytest.approx(want, rel=1e-6)
    if masked:
        zero = cross_entropy(torch.from_numpy(logits),
                             torch.from_numpy(labels).long(),
                             torch.zeros(3, 7, dtype=torch.bool))
        assert float(zero) == float(j_cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels), jnp.zeros((3, 7)))) \
            == 0.0


def test_serving_builds_no_graph_with_trainable_weights():
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              dtype="float32")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    model.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab, (2, 6),
                         generator=torch.Generator().manual_seed(1))
    logits = model.prefill({"tokens": toks})
    assert logits.grad_fn is None and not logits.requires_grad
    cache = model.cache_init(2, 8)
    out, cache = model.decode_step(cache, toks[:, :1], 0)
    assert out.grad_fn is None and not out.requires_grad
    assert all(not t.requires_grad for t in cache["layers"][0].values())
    res = serve.generate(model, toks, 2)
    assert all(x.grad_fn is None for x in res.step_logits)
    # the training forward of the same weights is differentiable
    fwd, _ = model.forward({"tokens": toks})
    assert fwd.grad_fn is not None


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_launcher_trains_on_cpu_and_checkpoints(tmp_path):
    ck = str(tmp_path / "run" / "w.npz")
    res = train.main(["--arch", "llama3-8b", "--steps", "6", "--batch",
                      "4", "--seq", "32", "--device", "cpu", "--dtype",
                      "float32", "--ckpt", ck])
    assert len(res.losses) == len(res.lrs) == len(res.step_ms) == 6
    assert all(np.isfinite(res.losses)) and res.losses[-1] < res.losses[0]
    assert res.lrs[0] == 0.0 and res.lrs[1] == pytest.approx(3e-4)
    assert res.peak_bytes is None and res.tokens_per_step == 128
    assert res.n_params == sum(p.numel() for p in res.model.parameters())
    cfg = res.model.cfg
    loaded = load_pytree(params_to_numpy(res.model), ck)
    back = params_from_numpy(cfg, loaded, "cpu")
    for (n, a), (_, b) in zip(res.model.named_parameters(),
                              back.named_parameters()):
        assert torch.equal(a, b), n
    # the reference's loader takes the port's file
    template = JModel(configs("llama3-8b")[0]).init(jax.random.PRNGKey(0))
    j_tree = j_load_pytree(template, ck)
    assert jax.tree.structure(j_tree) == jax.tree.structure(template)


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-small",
                                  "granite-moe-3b-a800m"])
def test_launcher_runs_every_input_family(arch):
    res = train.main(["--arch", arch, "--steps", "2", "--batch", "2",
                      "--seq", "16", "--device", "cpu", "--dtype", "float32",
                      "--accum", "2"])
    assert all(np.isfinite(res.losses)) and len(res.losses) == 2


def test_launcher_dry_run_and_missing_card_raise(monkeypatch):
    # --dry-run counts the production-mesh train step (no card needed)
    (rec,) = train.main(["--arch", "olmo-1b", "--dry-run"])
    assert (rec["arch"], rec["shape"], rec["mode"]) == ("olmo-1b",
                                                        "train_4k", "train")
    assert rec["hlo_flops"] > 0 and 0 < rec["useful_ratio"] < 10
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        train.main(["--arch", "olmo-1b", "--steps", "1"])
