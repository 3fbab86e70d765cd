"""Generate the §Dry-run and §Roofline tables from dry-run records (a
copy of the JAX package's ``launch/report.py``; the port's records keep
the reference's keys, so the tables are the same strings).

Usage: PYTHONPATH=src python -m repro_torch.launch.report [--dir DIR]
Prints markdown to stdout from the ``*.json`` records in ``DIR`` (one
record a file; default ``experiments/dryrun``).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List


def load(dirpath: str) -> List[dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def _fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def dryrun_table(recs: List[dict]) -> str:
    lines = ["| arch | shape | mesh | compile | HBM/device (args+temp) | "
             "collective schedule (per-device bytes) |",
             "|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda r: (r["mesh"], r["arch"], r["shape"])):
        mem = r.get("mem_per_device", {})
        args = (mem.get("argument_size_bytes") or 0) / 1e9
        temp = (mem.get("temp_size_bytes") or 0) / 1e9
        coll = ", ".join(f"{k}:{v / 1e9:.2f}GB"
                         for k, v in sorted(r.get("coll_bytes", {}).items())
                         if v > 1e6) or "none>1MB"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r.get('compile_s', '?')}s | {args:.2f}+{temp:.2f} GB | "
            f"{coll} |")
    return "\n".join(lines)


def roofline_table(recs: List[dict]) -> str:
    lines = ["| arch | shape | t_compute | t_memory | t_collective | "
             "bottleneck | MODEL_FLOPS | useful ratio | next lever |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        if r["mesh"] != "16x16":
            continue
        lever = _lever(r)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_s(r['t_compute_s'])} | "
            f"{_fmt_s(r['t_memory_s'])} | {_fmt_s(r['t_collective_s'])} | "
            f"**{r['bottleneck']}** | {r['model_flops']:.3g} | "
            f"{r['useful_ratio']:.3f} | {lever} |")
    return "\n".join(lines)


def _lever(r: dict) -> str:
    b = r["bottleneck"]
    shape = r["shape"]
    if b == "collective":
        if shape == "train_4k":
            return "reduce FSDP all-gather: larger per-layer shards / TP"
        return "re-layout boundaries: planner scheme change"
    if b == "memory":
        if "decode" in shape or shape == "long_500k":
            return "shrink per-token reads: resident weights, bf16 cache"
        return "remat policy / fused attention tiles"
    return "MXU-align tiles; raise arithmetic intensity"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    args = ap.parse_args()
    recs = load(args.dir)
    pods = {r["mesh"] for r in recs}
    n16 = sum(1 for r in recs if r["mesh"] == "16x16")
    nmp = sum(1 for r in recs if r["mesh"] == "2x16x16")
    print(f"## §Dry-run ({n16} single-pod + {nmp} multi-pod records, "
          f"meshes: {sorted(pods)})\n")
    print(dryrun_table(recs))
    print("\n## §Roofline (single-pod 16x16, per-device terms)\n")
    print(roofline_table(recs))


if __name__ == "__main__":
    main()
