"""Data-driven FCO on the PyTorch/CUDA port, as the paper runs it: collect
traces from the (simulated) testbed, fit the GBDT i-/s-Estimators on the
card, plan with DPP, and compare the data-driven plan against the oracle
optimum across bandwidths and topologies.

The counterpart of ``examples/plan_edge_cnn.py``: the traces and the fit
are the reference's (the forests equal bit for bit), so at the same flags
every plan line is the same.  Runs on the card; ``--device cpu`` fits on
the CPU.

Run:  PYTHONPATH=src python examples/torch_plan_edge_cnn.py \\
          [--samples 20000] [--trees 60] [--device cpu]
"""
import argparse
import sys
import time

from repro_torch.configs.edge_models import EDGE_MODELS
from repro_torch.core import AnalyticEstimator, Testbed, Topology
from repro_torch.core.dpp import plan_search
from repro_torch.core.partition import Mode
from repro_torch.core.plan import plan_cost
from repro_torch.launch import require_device
from repro_torch.sim import TraceConfig, train_estimators


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=20_000,
                    help="traces per estimator (paper: 330K)")
    ap.add_argument("--trees", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    print(f"collecting {args.samples} traces and training the estimators...")
    t0 = time.time()
    est = train_estimators(TraceConfig(n_samples=args.samples),
                           gbdt_kwargs=dict(n_estimators=args.trees,
                                            max_depth=7),
                           device=dev)
    print(f"  trained in {time.time() - t0:.1f}s on {dev.type}")

    oracle = AnalyticEstimator()
    worst = 0.0
    for model, fn in EDGE_MODELS.items():
        g = fn()
        for bw in (5.0, 1.0, 0.5):
            for topo in (Topology.RING, Topology.PS):
                tb = Testbed(nodes=4, bandwidth_gbps=bw, topology=topo)
                plan = plan_search(g, est, tb).plan
                nt = sum(1 for _, m in plan.steps if m == Mode.NT)
                true_cost = plan_cost(g, plan, oracle, tb)
                opt = plan_search(g, oracle, tb).cost
                gap = true_cost / opt - 1
                worst = max(worst, gap)
                print(f"  {model:10s} bw={bw:3.1f} {topo.name:4s} "
                      f"NT={nt:2d}  data-driven={true_cost * 1e3:7.2f}ms "
                      f"oracle-opt={opt * 1e3:7.2f}ms gap={gap * 100:5.1f}%")
    print(f"worst gap: {worst * 100:.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
