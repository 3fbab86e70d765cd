"""The benchmark stands apart: nothing it loads or runs imports JAX or the
JAX package ``repro`` (by whole top-level name: the port ``repro_torch``
begins with it), the references import nothing of the port, nothing
reads the JAX package's ``benchmarks/``, and a run without a card, or
without the program beside it, prints no result."""
import json
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)
ENV = {"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}", "PATH": "/usr/bin:/bin"}


def test_loading_and_running_the_harness_loads_no_jax_and_no_repro():
    code = textwrap.dedent("""
        import importlib, json, pkgutil, sys
        sys.argv = ["run"]
        import bench.run, bench.control
        import bench.drivers, bench.metrics
        for pkg in (bench.drivers, bench.metrics):
            for m in pkgutil.iter_modules(pkg.__path__):
                importlib.import_module(f"{pkg.__name__}.{m.name}")
        from bench.tests import tiny_cells
        results = [tiny_cells.run(c, requests=1)["correct"] for c in
                   ("olmo-1b.serve.short", "flexpie-decode.mesh4.chat")]
        print(json.dumps({"correct": results,
                          "loaded": bench.run.forbidden_modules(),
                          "port": "repro_torch" in sys.modules}))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": [True, True], "loaded": [], "port": True}


def test_forbidden_names_are_whole_top_level_names():
    from bench import run
    assert run.forbidden_modules(["repro_torch.x", "repro_torch_fake",
                                  "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["repro.core", "jax._src", "jaxlib",
                                  "flax.linen"]) == ["flax", "jax",
                                                     "jaxlib", "repro"]


def test_no_source_imports_jax_or_reads_benchmarks():
    imports = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|flax|repro)"
                         r"(?:[.\s,]|$)", re.MULTILINE)
    for path in SOURCES:
        text = path.read_text()
        assert not imports.search(text), path
        assert "benchmarks/" not in text and '"benchmarks"' not in text, path


def test_the_references_import_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        text = path.read_text()
        assert "repro_torch" not in text, path
        assert not re.search(r"^\s*(?:from|import)\s+bench\.(?!reference)",
                             text, re.MULTILINE), path


def test_without_a_card_the_run_prints_no_result():
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "olmo-1b.serve.short", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         env=ENV, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_without_the_program_the_run_prints_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = textwrap.dedent("""
        import runpy, sys
        import torch
        torch.cuda.is_available = lambda: True     # past the card check
        torch.cuda.device_count = lambda: 1
        sys.argv = ["bench/run.py", "--workload", "flexpie-decode.mesh4.chat",
                    "--seed", "1", "--seconds", "1", "--trace", "0"]
        runpy.run_path("bench/run.py", run_name="__main__")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin"}, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "repro_torch" in out.stderr
