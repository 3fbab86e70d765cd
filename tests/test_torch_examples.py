"""The port's example scripts (``examples/torch_*.py``,
``experiments/torch_hillclimb.py``) on the CPU, against the JAX package's
scripts where the two print the same thing.

* ``torch_quickstart`` and ``torch_plan_edge_cnn`` print the same plan
  lines as ``quickstart`` and ``plan_edge_cnn`` at the same flags: the
  planning is host-side and deterministic, and the port's GBDT fit is the
  reference's forest bit for bit.
* The LM scripts draw their weights from torch's generator, so they are
  held to what holds whatever the weights: finite, falling losses, and
  generated tokens with the fused prefill agreeing with the decode-fed
  logits.
* The hillclimb runs its four pairs at a reduced size (``reduced()``
  configs on a 2 x 4 mesh): every row counted.
* Without a card and without ``--device cpu`` each script raises, and
  ``torch_train_lm --devices 2`` raises naming ROADMAP A 10.
"""
import importlib.util
import re
import sys
from pathlib import Path

import pytest

from repro_torch.launch.dryrun import run_one
from repro_torch.launch.mesh import ShapeMesh
from torch_lm_cases import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = {
    "torch_quickstart": ROOT / "examples" / "torch_quickstart.py",
    "torch_plan_edge_cnn": ROOT / "examples" / "torch_plan_edge_cnn.py",
    "torch_serve_llm": ROOT / "examples" / "torch_serve_llm.py",
    "torch_train_lm": ROOT / "examples" / "torch_train_lm.py",
    "torch_hillclimb": ROOT / "experiments" / "torch_hillclimb.py",
    "quickstart": ROOT / "examples" / "quickstart.py",
    "plan_edge_cnn": ROOT / "examples" / "plan_edge_cnn.py",
}


def load(name):
    """The script ``name`` as a module (its ``__main__`` block not run)."""
    spec = importlib.util.spec_from_file_location(f"script_{name}",
                                                  SCRIPTS[name])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(name, argv, capsys, monkeypatch):
    """``main`` of the script ``name`` in this process with ``argv`` as
    its command line: (its return value, what it printed)."""
    monkeypatch.setattr(sys, "argv", [str(SCRIPTS[name]), *argv])
    mod = load(name)
    capsys.readouterr()
    rc = mod.main(argv) if name.startswith("torch_") else mod.main()
    return rc, capsys.readouterr().out


def test_quickstart_plans_as_the_reference(capsys, monkeypatch):
    rc, port = run_main("torch_quickstart", ["--device", "cpu"], capsys,
                        monkeypatch)
    assert rc == 0
    _, ref = run_main("quickstart", [], capsys, monkeypatch)

    def plan_lines(out):
        return out.split("== executing")[0].splitlines()
    assert plan_lines(port) == plan_lines(ref)
    assert len(plan_lines(port)) > 30
    assert "reassembly max|err|" in port and port.rstrip().endswith("OK")


def test_plan_edge_cnn_plans_as_the_reference(capsys, monkeypatch):
    flags = ["--samples", "300", "--trees", "5"]
    rc, port = run_main("torch_plan_edge_cnn", flags + ["--device", "cpu"],
                        capsys, monkeypatch)
    assert rc == 0
    rrc, ref = run_main("plan_edge_cnn", flags, capsys, monkeypatch)
    assert rrc == 0

    def plan_lines(out):
        return [ln for ln in out.splitlines() if "trained in" not in ln]
    assert plan_lines(port) == plan_lines(ref)
    assert sum("gap=" in ln for ln in plan_lines(port)) == 30


@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-1.2b"])
def test_serve_llm_generates(arch, capsys, monkeypatch):
    rc, out = run_main("torch_serve_llm", ["--arch", arch, "--gen", "8",
                                           "--device", "cpu"],
                       capsys, monkeypatch)
    assert rc == 0
    reqs = re.findall(r"req\d: \[.*\]\.\.\. -> \[(.*)\]\.\.\.", out)
    assert len(reqs) == 2
    assert all(len(r.split(",")) == 8 for r in reqs)
    m = re.search(r"fused prefill against decode-fed logits: (\S+) of "
                  r"scale", out)
    assert m and float(m.group(1)) < 1e-3
    assert out.rstrip().endswith("OK")


def test_train_lm_losses_fall(tmp_path, capsys):
    """The script's loop on a smaller model of the same family (its
    ``CONFIG`` cut to 2 layers of width 128 and a vocabulary of 512), 40
    steps of 4 x 32 tokens: finite losses that fall, the script's verdict
    (final loss below 9.5) and the checkpoint written."""
    mod = load("torch_train_lm")
    mod.CONFIG = dict(mod.CONFIG, n_layers=2, d_model=128, n_heads=4,
                      n_kv=2, d_ff=256, vocab=512)
    ckpt = tmp_path / "lm.npz"
    rc = mod.main(["--steps", "40", "--batch", "4", "--seq", "32",
                   "--ckpt", str(ckpt), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    losses = [float(x) for x in re.findall(r"loss=(\S+)", out)]
    assert len(losses) == 3                  # steps 0, 20 and 39
    assert all(l == l and l < 20 for l in losses)
    assert losses[0] > losses[1] > losses[2]
    assert ckpt.stat().st_size > 0


def test_hillclimb_counts_every_row(tmp_path, monkeypatch):
    """Every pair at a reduced size: each row's config ``reduced()`` (then
    the row's own transform) on a data 2 x model 4 mesh."""
    hc = load("torch_hillclimb")

    def reduced_run_one(arch, shape, cfg_transform=None, **kw):
        def tf(cfg):
            cfg = cfg.reduced()
            return cfg_transform(cfg) if cfg_transform else cfg
        return run_one(arch, shape, cfg_transform=tf,
                       mesh=ShapeMesh({"data": 2, "model": 4}), **kw)
    monkeypatch.setattr(hc, "run_one", reduced_run_one)
    out = hc.run("all", device="cpu", out_dir=str(tmp_path))
    assert {k: len(v) for k, v in out.items()} == \
        {k: len(v) for k, v in hc.EXPERIMENTS.items()}
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["A.json", "B.json", "C.json", "D.json"]
    a = {r["label"]: r["hlo_bytes"] for r in out["A"]}
    for label, b in a.items():
        if label.startswith("chunked"):
            assert b < a["baseline recurrent scan"], label
    assert a["zamba2 chunked C=64"] < a["zamba2 baseline recurrent"]
    for pair in ("B", "C"):
        by_moe = {}
        for r in out[pair]:
            by_moe.setdefault(r["strategy"]["moe"], []).append(
                r["coll_bytes"])
        for ep in by_moe.get("ep", []):
            assert "all-to-all" in ep
            assert all(ep != tp for tp in by_moe.get("tp", []))


@pytest.mark.parametrize("name,argv", [
    ("torch_quickstart", []), ("torch_plan_edge_cnn", ["--samples", "10"]),
    ("torch_serve_llm", []), ("torch_train_lm", ["--steps", "1"]),
    ("torch_hillclimb", ["D"])])
def test_without_a_card_each_script_raises(name, argv):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is there")
    with pytest.raises(RuntimeError, match="--device cpu"):
        load(name).main(argv)


def test_train_lm_over_several_devices_names_a10():
    with pytest.raises(NotImplementedError, match="A 10"):
        load("torch_train_lm").main(["--devices", "2", "--device", "cpu"])
