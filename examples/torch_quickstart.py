"""Quickstart on the PyTorch/CUDA port: FlexPie end to end.

1. Build MobileNet's layer graph.
2. Run the FCO planner (DPP + analytic cost oracle) for a 4-node edge
   testbed and print the chosen per-layer (scheme, mode) plan.
3. Execute the plan on simulated nodes through the hand-written shard
   kernels and verify exact reassembly: a 9-layer prefix at 56x56, as
   the JAX example does, then the whole network at 56x56, its FC head
   through the FC kernel.  Both are held to the unpartitioned plain run
   in full f32 (TF32 off on the card), the reference's 1e-4.

The counterpart of ``examples/quickstart.py``; the plan and the baseline
lines are the same, planning being host-side and deterministic.  Runs on
the card; ``--device cpu`` runs the kernels' plain versions on the CPU.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import sys

import torch

from repro_torch.configs.edge_models import mobilenet_v1
from repro_torch.core import AnalyticEstimator, Testbed, chain
from repro_torch.core.baselines import all_solutions, performance_scores
from repro_torch.core.dpp import plan_search
from repro_torch.launch import require_device
from repro_torch.runtime.engine import init_weights, run_reference
from repro_torch.runtime.session import ExecConfig, Session


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    est = AnalyticEstimator()
    tb = Testbed(nodes=4, bandwidth_gbps=1.0)

    g = mobilenet_v1()
    res = plan_search(g, est, tb)
    print(f"== FlexPie plan for {g.name} on {tb.nodes} nodes "
          f"@ {tb.bandwidth_gbps} Gb/s "
          f"(est. {res.cost * 1e3:.2f} ms, "
          f"{res.stats.i_calls + res.stats.s_calls} estimator calls)")
    for layer, (scheme, mode) in zip(g.layers, res.plan.steps):
        print(f"  {layer.name:10s} {scheme.name:7s} {mode.name}")

    print("\n== vs baselines")
    sols = all_solutions(g, est, tb)
    scores = performance_scores({k: v[1] for k, v in sols.items()})
    for k, (plan, t) in sorted(sols.items(), key=lambda kv: kv[1][1]):
        print(f"  {k:14s} {t * 1e3:8.2f} ms   score={scores[k]:.3f}")

    print(f"\n== executing the plan on 4 simulated nodes (56x56 prefix, "
          f"{dev.type})")
    g_small = chain("mb_prefix", mobilenet_v1(width=56).layers[:9])
    gen = torch.Generator(device=dev).manual_seed(0)
    ws = init_weights(g_small, gen, device=dev)
    x = torch.randn((56, 56, 3), generator=gen, device=dev)
    plan = plan_search(g_small, est, tb).plan
    out, stats = Session(g_small, ws, plan, tb.nodes,
                         ExecConfig(device=str(dev))).run(x)
    ref = run_reference(g_small, ws, x)
    err = float((out - ref).abs().max())
    print(f"  reassembly max|err| = {err:.2e}  "
          f"(sync points: {stats.sync_points}, "
          f"received: {stats.bytes_received / 1e3:.1f} KB)")
    assert err < 1e-4

    g56 = mobilenet_v1(width=56)
    ws = init_weights(g56, gen, device=dev)
    plan = plan_search(g56, est, tb).plan
    out, stats = Session(g56, ws, plan, tb.nodes,
                         ExecConfig(device=str(dev))).run(x)
    ref = run_reference(g56, ws, x)
    err = float((out - ref).abs().max() / max(1.0, float(ref.abs().max())))
    print(f"  whole {g56.name} at 56x56: max|err| = {err:.2e} of scale  "
          f"(sync points: {stats.sync_points}, "
          f"received: {stats.bytes_received / 1e3:.1f} KB)")
    assert err < 1e-4
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
