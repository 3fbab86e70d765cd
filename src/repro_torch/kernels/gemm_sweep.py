"""Sweep of the shared GEMM tile loop's configs and K splits on the card.

    PYTHONPATH=src python -m repro_torch.kernels.gemm_sweep

On a machine with a CUDA card and the toolkit.  For the FC and dense conv
shard shapes of the main path at 4 nodes (bert-base's four ``[32, K] @
[K, N]`` shards, the classifier heads, ResNet-18's and MobileNet's
costliest conv shards), in f32 and in bf16, it times every tile config
the launcher takes for the pair (:func:`repro_torch.kernels.gemm.
configs_for`: the CUDA-core configs in f32, the tensor-core ones in
bf16) at each K split that whole slabs allow, and prints the fastest few
and the fastest of each loop beside the split that
:func:`~repro_torch.kernels.gemm.plan_gemm`
picks and one PyTorch library call on the same inputs in the same
dtype.  Times are device time per call: a pass's worth of calls (12
weights, 4 calls each, as four nodes share a layer's weight) captured as
one CUDA graph and replayed between CUDA events.  It also prints the
replayed time of one trivial kernel (the launch floor) and, from
``torch.profiler`` over isolated FC calls, the tile loop's device time
alone and the split-K reduction's span.  TF32 is off for the library
calls.  Exits non-zero without a card.
"""
from __future__ import annotations

import subprocess
import sys

import torch
import torch.nn.functional as F

from . import gemm
from .conv2d import conv2d_shard, shard_out_shape
from .ops import matmul_tiled

#: (m, k, n) of the FC shards
FC_SHAPES = ((32, 768, 2304), (32, 2304, 768), (32, 768, 3072),
             (32, 3072, 768), (1, 1024, 250), (1, 512, 250))
#: (rows, width, cin, cout, k, stride, pads) of dense conv shards
CONV_SHAPES = (
    (16, 56, 64, 64, 3, 1, (0, 0, 1, 1)),
    (4, 7, 512, 512, 3, 1, (0, 0, 1, 1)),
    (63, 224, 3, 64, 7, 2, (0, 0, 3, 2)),
    (9, 28, 128, 128, 3, 1, (0, 0, 1, 1)),
    (4, 14, 512, 512, 1, 1, (0, 0, 0, 0)),
    (15, 56, 128, 128, 1, 1, (0, 0, 0, 0)),
    (29, 112, 32, 64, 1, 1, (0, 0, 0, 0)),
)
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
REPS = 10
SHOW = 4


def replay_us(fn, calls: int) -> float:
    """Device microseconds per call of ``fn`` (which makes ``calls``
    calls), replayed as one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / REPS / calls


def sweep(label, m, n, kdim, kernel, library, calls, mma):
    """Time ``kernel`` under every config the pair's launcher takes and
    every split; print the best, and the best of each loop."""
    chosen = gemm.plan_gemm(m, n, kdim, mma)
    plans = {(chosen.cfg.index, chosen.splits): chosen}
    for cfg in gemm.configs_for(mma):
        for want in SPLITS:
            plan = gemm.split_plan(cfg, m, n, kdim, want)
            plans.setdefault((cfg.index, plan.splits), plan)
    real = gemm.plan_gemm
    rows = []
    try:
        for plan in plans.values():
            gemm.plan_gemm = lambda *_a, plan=plan: plan
            rows.append((replay_us(kernel, calls), plan.cfg.index,
                         plan.splits, plan.blocks, plan.cfg.route))
    finally:
        gemm.plan_gemm = real
    pick = rows[0][0]
    rows.sort()
    best = "; ".join(f"cfg {c} x {s} splits ({b} blocks) {t:.2f}"
                     for t, c, s, b, _ in rows[:SHOW])
    per_loop = "; ".join(
        f"{r}: cfg {c} x {s} splits {t:.2f}"
        for r in ("tensor_cores", "cuda_cores")
        for t, c, s, _, _ in [row for row in rows if row[4] == r][:1])
    print(f"{label}: chooser cfg {chosen.cfg.index} x {chosen.splits} "
          f"splits {pick:.2f} us; library {replay_us(library, calls):.2f} "
          f"us; fastest: {best}; fastest by loop: {per_loop}", flush=True)


def isolated_us(x, w):
    """Device time of the tile loop alone and the split-K reduction's
    span over isolated calls (synchronised between calls, so no call
    overlaps another).  The reduction is launched as a programmatic
    dependent and starts before the tile loop ends, so its span is not
    its own time."""
    from torch.profiler import ProfilerActivity, profile
    matmul_tiled(x, w)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            matmul_tiled(x, w)
            torch.cuda.synchronize()
    spans = {"loop": 0.0, "reduce": 0.0}
    for ev in prof.key_averages():
        key = "reduce" if "splitk_reduce" in ev.key else \
            "loop" if "gemm_kernel" in ev.key or "mma_kernel" in ev.key \
            else None
        if key:
            spans[key] += ev.device_time_total / 20
    return spans


def main() -> int:
    if not torch.cuda.is_available():
        print("gemm_sweep: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    t = torch.zeros(1024, device=dev)
    floor = replay_us(lambda: [t.mul_(1.0) for _ in range(48)], 48)
    print(f"launch floor: {floor:.2f} us per trivial kernel", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        mma = dtype != torch.float32
        tag = str(dtype).replace("torch.", "")
        for m, k, n in FC_SHAPES:
            x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            ws = [torch.randn((k, 4 * n), generator=gen,
                              device=dev).to(dtype)[:, n:2 * n]
                  for _ in range(12)]
            sweep(f"{tag} fc [{m},{k}] @ [{k},{n}]", m, n, k,
                  lambda: [matmul_tiled(x, w) for w in ws for _ in range(4)],
                  lambda: [torch.matmul(x, w) for w in ws for _ in range(4)],
                  48, mma)
            spans = isolated_us(x, ws[0])
            print(f"  isolated calls (torch.profiler): tile loop "
                  f"{spans['loop']:.2f} us, split-K reduction span "
                  f"{spans['reduce']:.2f} us", flush=True)
        for rows, width, cin, cout, k, s, pads in CONV_SHAPES:
            x = torch.randn((rows, width + 2, cin), generator=gen,
                            device=dev).to(dtype)[:, 1:1 + width]
            ws = [torch.randn((k, k, cin, cout), generator=gen,
                              device=dev).to(dtype) for _ in range(4)]
            ho, wo = shard_out_shape(rows, width, k, s, pads)
            pt, pb, pl_, pr = pads
            xn = F.pad(x.permute(2, 0, 1)[None], (pl_, pr, pt, pb))
            wn = [w.permute(3, 2, 0, 1) for w in ws]
            sweep(f"{tag} conv [{rows},{width},{cin}] k{k} s{s} pads "
                  f"{pads} -> {cout}", ho * wo, cout, k * k * cin,
                  lambda: [conv2d_shard(x, w, pads=pads, stride=s)
                           for w in ws],
                  lambda: [F.conv2d(xn, w, stride=s) for w in wn], len(ws),
                  mma)
    print(f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
