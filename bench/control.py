"""Readings for the limits of a cell's comparison, on the chip:

    python3 bench/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--requests N]

For each seed, one process sets the cell's entry point up anew (weights
from that seed), serves the first ``N`` requests of the cell's traffic
(default: as many as a run's comparison reads) and prints one JSON line
with the program's numbers (``compare.program_numbers``, the comparison a
run makes).  For each control seed it also prints the control's numbers:
the plain reference computed in the configuration's ``control`` precision
(the step below the one the configuration states) in the program's place,
on the same prompts and tokens (``compare.control_numbers``).  A number's
limit lies between the largest program reading and the smallest control
reading; ``PERF.md`` keeps both.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def readings(cell, seed: int, control: bool, device, requests=None):
    """One seed's readings: the program's numbers and, with ``control``,
    the control's."""
    import torch
    from bench import compare, harness
    device = torch.device(device)
    drv = harness.driver_of(cell.config).Driver(
        cell.config, cell.mix, cell.spec["check"], seed, device)
    drv.warm_up()
    n = requests or cell.spec["check"]["requests"]
    t0 = time.perf_counter()
    served, _ = harness.window(drv, cell.mix, seed, 0.0, n, requests=n)
    window_s = time.perf_counter() - t0
    drv.release()
    samples = drv.samples(harness.sampled(served))
    out = {"seed": seed, "requests": n, "window_s": window_s,
           "served_tokens": sum(len(s.served) for s in samples),
           "program": compare.program_numbers(samples, drv.reference)}
    if control:
        def ctl(tokens, positions):
            return drv.reference(tokens, positions,
                                 rounding=cell.config["control"])
        out["control"] = compare.control_numbers(samples, drv.reference,
                                                 ctl)
        out["precision"] = cell.config["control"]
    del drv, served, samples
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--requests", type=int, default=None)
    args = ap.parse_args(argv)
    import torch
    from bench import harness
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in seeds + controls:
        r = readings(cell, seed, seed in controls, "cuda:0", args.requests)
        r["workload"] = args.workload
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
