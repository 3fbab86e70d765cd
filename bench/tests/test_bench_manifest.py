"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding every cell, configuration, traffic mix and metric by name."""
import json
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from bench import harness, traffic

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys_and_the_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["bench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    cmd = MANIFEST["command"]
    assert len(cmd) <= 32 and (ROOT / cmd[1]).is_file()
    assert cmd[1].startswith("bench/")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries_keys_names_and_units(kind):
    names = [e["name"] for e in MANIFEST[kind]]
    assert len(names) == len(set(names))
    for e in MANIFEST[kind]:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] \
                    and "\t" not in e[text]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_metrics_sources_bounds_and_cells():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        if "roofline" in m["name"]:       # a kernel's: <kernel>_roofline
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for cell in CELLS:
        reported = [m for m in MANIFEST["end_to_end"]
                    if harness.reported(m, cell)]
        assert {"setup_s"} < {m["name"] for m in reported}
        assert any(harness.reported(m, cell) for m in MANIFEST["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files_by_name(cell):
    c = harness.load_cell(cell)
    assert c.entry["chips"] == 1
    conf = next(e for e in MANIFEST["configs"]
                if e["name"] == c.entry["config"])
    assert conf["file"] == f"bench/configs/{conf['name']}.json"
    assert c.config["name"] == conf["name"]
    assert c.config["reduced"] == conf["reduced"]
    assert (ROOT / "bench" / "drivers"
            / f"{c.config['driver']}.py").is_file()
    assert (ROOT / "bench" / "reference"
            / f"{c.config['reference']}.py").is_file()
    for m in c.metrics["end_to_end"] + c.metrics["per_layer"]:
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
    assert set(c.spec) == {"check", "trace", "limits"}
    assert set(c.spec["limits"]) == {"token_gap", "logit_err"}
    assert next(traffic.requests(c.mix, 1)).steps <= \
        c.mix.get("capacity", 10 ** 9)


def test_every_config_is_used_and_its_files_named_alike():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    for path in (ROOT / "bench").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            assert re.match(r"^[A-Za-z0-9_./\-]+$",
                            str(path.relative_to(ROOT)))


def test_a_cell_added_as_files_is_found_without_editing_any(tmp_path):
    """A copy of the benchmark gains a cell, a traffic mix and a per-layer
    metric by new files and new entries alone; the harness reads them."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["workloads"].append({
        "name": "flexpie-decode.mesh4.burst", "config": "flexpie-decode",
        "traffic": "one-user.burst", "chips": 1, "why": "a new cell"})
    manifest["per_layer"].append({
        "name": "steps_traced", "unit": "steps", "better": "higher",
        "source": "device_trace", "layer": "Model step",
        "moves": "tok_per_s", "workloads": ["flexpie-decode.mesh4.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    (tmp_path / "bench/traffic/one-user.burst.json").write_text(json.dumps({
        "loop": "closed", "clients": 1, "batch": 1, "prompt_len": [16, 32],
        "gen_len": [8, 8], "sizes": 3, "capacity": 64}))
    (tmp_path / "bench/workloads/flexpie-decode.mesh4.burst.json").write_text(
        json.dumps({"check": {"requests": 1},
                    "trace": {"request": 0, "last_steps": 4},
                    "limits": {"token_gap": 1.0, "logit_err": 1.0}}))
    (tmp_path / "bench/metrics/steps_traced.py").write_text(
        "def read(run):\n    return 7.0\n")
    code = textwrap.dedent("""
        import json, sys
        from bench import harness, traffic
        cell = harness.load_cell("flexpie-decode.mesh4.burst")
        reqs = traffic.requests(cell.mix, 5)
        sizes = sorted({(r.prompt_len, r.gen_len)
                        for r in (next(reqs) for _ in range(3))})
        run = harness.Run(cell, None, 0.0, 1.0, [], None)
        print(json.dumps({"config": cell.config["name"], "sizes": sizes,
                          "per_layer": harness.read_metrics(run,
                                                            "per_layer")}))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": f"{tmp_path}:{ROOT / 'src'}",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["config"] == "flexpie-decode"
    assert got["sizes"] == [[16, 8], [24, 8], [32, 8]]
    assert got["per_layer"]["steps_traced"] == {"value": 7.0,
                                                "unit": "steps"}
