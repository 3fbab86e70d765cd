"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the
port's example scripts (``examples/torch_*.py``,
``experiments/torch_hillclimb.py``) import neither JAX nor any module of
the JAX package ``repro``.

The import check runs in a subprocess, because this test process may have
JAX loaded already; the source scan catches imports on paths the import
check does not execute.
"""
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"
SCRIPTS = [ROOT / "examples" / f"torch_{n}.py"
           for n in ("quickstart", "plan_edge_cnn", "serve_llm", "train_lm")] \
    + [ROOT / "experiments" / "torch_hillclimb.py"]

_FORBIDDEN = re.compile(r"^\s*(?:from|import)\s+(jax|repro)(?:[.\s,]|$)",
                        re.MULTILINE)


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    code = textwrap.dedent(f"""
        import importlib, importlib.util, json, pkgutil, sys
        import repro_torch
        mods = sorted(m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch."))
        for m in mods:
            importlib.import_module(m)
        for i, path in enumerate([{str(SMOKE)!r}]
                                 + {[str(p) for p in SCRIPTS]!r}):
            spec = importlib.util.spec_from_file_location(f"script{{i}}",
                                                          path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "repro"))
        print(json.dumps({{"mods": mods, "bad": bad}}))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    expected = {"repro_torch.core.dpp", "repro_torch.kernels.build",
                "repro_torch.kernels.conv2d", "repro_torch.kernels.ops",
                "repro_torch.kernels.flash_attention",
                "repro_torch.runtime.engine", "repro_torch.runtime.session",
                "repro_torch.runtime.decode", "repro_torch.runtime.kv_cache",
                "repro_torch.runtime.mesh_exec", "repro_torch.launch.mesh",
                "repro_torch.configs.edge_models",
                "repro_torch.cluster.spec", "repro_torch.cluster.estimator",
                "repro_torch.cluster.simsched",
                "repro_torch.cluster.calibrate", "repro_torch.cluster.refine",
                "repro_torch.cluster.serving", "repro_torch.cluster.elastic",
                "repro_torch.cluster.churn", "repro_torch.obs",
                "repro_torch.obs.trace", "repro_torch.obs.metrics",
                "repro_torch.obs.flight", "repro_torch.obs.log",
                "repro_torch.obs.skew"}
    assert expected <= set(out["mods"])


def test_port_sources_have_no_jax_or_repro_imports():
    files = sorted(PORT.rglob("*.py")) + [SMOKE] + SCRIPTS
    assert len(files) > 10 and all(f.exists() for f in SCRIPTS)
    offenders = {}
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        if hits:
            offenders[str(f.relative_to(ROOT))] = hits
    assert offenders == {}


def test_forbidden_pattern_catches_what_it_should():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import x",
                 "from repro.core import plan", "import repro",
                 "  from repro import Session", "import repro.core"):
        assert _FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import x",
                 "import jaxtyping_free", "# import jax in a comment? no",
                 "x = 'from repro'"):
        assert not _FORBIDDEN.search(line), line


def test_kernel_sources_are_listed_for_the_build():
    """Every CUDA source ships in the package and has its C entry points
    declared for ctypes."""
    from repro_torch.kernels import build
    srcs = {p.stem: p.read_text() for p in (PORT / "kernels" / "csrc")
            .glob("*.cu")}
    assert set(srcs) == set(build.SIGNATURES)
    for name, fns in build.SIGNATURES.items():
        for fn in fns:
            assert f'extern "C" int {fn}(' in srcs[name]
        assert "cudaGetLastError()" in srcs[name]
        assert "Replaces the Pallas TPU kernel src/repro/kernels/" in \
            srcs[name]
