"""The benchmark of the PyTorch and CUDA port, one cell a process:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  It sets the cell's entry point up (the
kernel libraries built into ``build/repro_torch/`` on a checkout's first
run, loaded after), makes the weights on the device from ``--seed`` and
warms up the cell's shapes; serves the cell's traffic for ``--seconds``
(every request that starts in time runs to its end); holds what the
window served to the plain reference; and prints, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones, read from a profiled slice of the window), ``device``,
``breakdown`` with ``--trace 1``, and ``compared`` last: each number the
comparison read beside its limit, which are also the last lines of
standard error.

It exits non-zero, printing no result, without a CUDA device (or with
fewer than the cell asks for), and when ``jax``, ``jaxlib``, ``flax`` or
the JAX package ``repro`` is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: top-level module names that must not be loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None):
    """The forbidden top-level names among ``names`` (default: the
    modules this process has loaded)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from bench import harness
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.entry["chips"]:
        print(f"bench: {args.workload} needs {cell.entry['chips']} cards, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    # f32 products in f32, as the configurations state
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"bench: the run loaded {loaded}", file=sys.stderr)
        return 3
    result["device"]["kind"] = torch.cuda.get_device_name(0)
    result["compared"] = result.pop("compared")      # the last key
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
