#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one CUDA card and the CUDA
toolkit.  It builds the hand-written kernels from ``src/repro_torch/
kernels/csrc``, holds each against its plain PyTorch version on the card,
then drives the port's paths at full width with random weights from fixed
seeds:

* the CNN/bert path — ``plan_search`` -> ``Session(...,
  ExecConfig(backend="cuda")).run(x)`` on MobileNet v1 (224x224),
  ResNet-18 (224x224) and bert-base (seq 128, d 768, 12 layers), run
  three times through the segment programs (``jit_segments``: eager,
  captured as CUDA graphs, replayed), each run's output bit-equal to the
  eager records' (``jit_segments=False``), each output checked against
  the unpartitioned reference and each ``ExecStats`` against the eager
  and the generic ``backend="torch"`` runs;
* the two shard kernels in bf16 and fp16 (phase 2's half grid) — every
  case of phase 2 with both operands in bf16 and in fp16, and a half
  input with f32 weights, an f32 input with bf16 weights and bf16 with
  fp16 at each geometry's first pad signature and the FC shapes: the
  output in the input's dtype and within one ulp of the plain version
  (``hold_ulp``; past one ulp only where an element cancels, within
  ``SUM_SLACK`` of its sum of |x * w|), one launch a call on its loop
  (a same-type pair's dense and FC calls on the tensor cores, the mixed
  pairs' on CUDA cores), the largest ulps, the share of elements that
  differ and the launches by loop printed;
* the CNN/bert path in bf16 (phase 4b) — phase 3's models, plans and
  seeds with the weights and input cast to bf16: eager records, then the
  segment programs' eager, capturing and replaying runs, bit-equal,
  launches equal to ``kernel_records``, every dense and FC call on the
  tensor cores (launches by loop), ``ExecStats`` equal to the f32
  run's, every call made outside a capture within one ulp of plain, the
  output within 2e-2 of scale of the f32 run, of ``run_reference`` in
  bf16 and of ``backend="torch"`` in bf16; the mesh executor, overlap on
  and off, bit-equal across its runs and within 2e-2 of the local bf16
  output; the warm replayed run in bf16 and f32 in turns with the idle
  share, and each kernel's bf16 calls of one pass beside plain, library
  (``F.pad`` + ``F.conv2d``, ``torch.matmul``, both in bf16) and the
  bound at 2-byte operands and 989 TFLOP/s, and each FC shape's calls
  against cuBLAS in bf16 (the ``bf16_*`` fields of the kernels line);
* the decode path — ``plan_decode`` -> ``greedy_decode(DecodeSession(...,
  ExecConfig(backend="cuda")))`` at OLMo-1B's widths and depth (16 layers,
  d 2048, 16 heads, d_ff 8192, vocab 50304) over 4 nodes, a 480-token
  prompt and 32 new tokens, the step one captured CUDA graph replayed per
  token — tokens checked against the card's ``reference_decode``, the
  ``backend="torch"`` session and the eager step body;
* the flash attention entry point ``ops.flash_attention`` at OLMo-1B
  prefill, llama3-8b GQA and zamba2-1.2b sliding-window shapes;
* the mesh executor (phase 9) — the same three models, weights, inputs
  and plans on ``ExecConfig(executor="mesh")``, each node a CUDA stream,
  one captured graph a pipeline stage, with the halo overlap on and off:
  eager, capturing and replaying runs bit-equal to each other, within
  1e-4 of the reference, ``ExecStats`` equal to the local run's, no fault
  counted, launches equal to ``mesh_kernel_records``, every kernel call
  of the eager run (the border strips' calls too, at shapes the local
  path never makes) held against its plain version; then the warm run
  against the local executor's, in turns, and a replayed
  ``instrument=True`` run's per-stage walls and per-node completion
  times;
* the mesh decode (phase 10) — phase 6's weights, plan and prompt on
  ``DecodeSession(..., ExecConfig(executor="mesh"))``: tokens against
  ``reference_decode`` and the local session, launches against the plan,
  and the warm step against the local step, in turns.
* the throughput planner's loop on measured occupancy (phase 11) —
  phase 3's models, weights and inputs on ``homogeneous(4, 0.5 Gbps)``
  (phase 3's testbed): the (compute, sync) frontier
  (``cluster_pipeline_frontier(prune_ub=False)``), then
  ``refine_with_simulator`` whose ``occupancy_fn`` runs each plan it
  tries on the mesh executor (``overlap=False``, ``instrument=True``:
  eager, capturing, replayed) and returns the replayed run's
  ``to_occupancy()``, then the frontier's two extreme plans; every plan
  run held to phase 9's checks and its measured stages to the port's own
  ``build_stages``;
* the data-driven planner (phase 12) — GBDT cost estimators fit on the
  card: (a) a forest fit by the port on the host CPU, carried to the card
  through its npz file, predicts bit-equal to the CPU and to the scalar
  walk; (b) homogeneous and hetero forests at
  ``benchmarks/estimator_quality.py``'s smoke budget fit on the card
  twice (bit-equal) and on the CPU, with the share of equal trees, the
  largest prediction gap and the held-out RMSE (within 1% of the CPU
  fit's); (c) that benchmark's quality gates (``hetero_within_5pct``,
  ``hetero_beats_hom``) on the device forests beside the committed
  ``benchmarks/baselines/BENCH_estimator.json``; (d) the paper's 330K
  traces and 120-tree forests, and the GBDT plan within 1.30x of the
  analytic optimum; (e) the six solutions of ``baselines.all_solutions``
  for phase 3's models on learned costs, each run through the local and
  the mesh executor under phases 3 and 9's checks (a plan that cuts an FC
  layer's columns prints its estimate and does not run: the reference
  cannot run it either); (f) phase 11's loop for ResNet-18 on the GBDT
  frontier.  One H100 driven by one host is not the paper's edge
  cluster: the scores of (e) are not its Fig. 7/9;
* observability and the elastic planner (phase 13) — (a) phase 3's
  models, plans and weights on the mesh with ``instrument=True``, overlap
  on and off, under a ``repro_torch.obs`` tracer: the control-track stage
  spans one to one with ``ExecStats.stage_times`` and a device span per
  node completion, the traced eager, capturing and replaying runs (and a
  traced replay of programs captured untraced) bit-equal to the untraced
  ones; the Perfetto JSON and metrics snapshot written to
  ``build/traces/`` and loaded back, the plan's simulated timeline
  (``simsched.simulate_trace``) diffed against the measured one, the
  measured-over-simulated skew per stage kind, where the run's host time
  goes, and the warm run with tracing off and on in turns; (b) a fault
  that one retry absorbs and a watchdog far below one stage's wall on the
  card (the ``stage_retry`` record and ``retry:`` instant; exactly one
  timeout postmortem), each followed by an ordinary run under phase 9's
  contract; (c) MobileNet's planner spans and cost-table dedup counters,
  and phase 11's ``refine.*`` gauges; (d) ``compare_strategies`` on
  MobileNet-224 over the reference churn benchmark's gated presets and
  scenarios (seed 0) with the reference's structural claims, and every
  distinct plan the incremental and scratch strategies adopt run on the
  mesh at its live node count under phases 3 and 9's contract;
* the LM substrate's serving path (phase 14) — (b) llama3-8b as the
  registry gives it (bf16, 32 layers, d 4096, 32 heads over 8 KV heads,
  d_ff 14336, vocab 128256; ~8.03 B parameters made on the card from
  seed 0) through ``repro_torch.launch.serve.main`` (4 x 16 prompt
  tokens fed through the decode step, 16 generated greedily, every step
  one replay of the captured decode program after its eager first call
  and its capture), each decode attention through ``flash_decode_paged``
  (bf16, grouped heads) on the cache read in place, ``kv_len`` from
  device memory, then ``generate`` eagerly on the same prompts: tokens
  and all 32 steps' logits bit-equal; then ``prefill`` of the served 4 x
  32 tokens and of 1 x 4096 through ``flash_attention_bh``: every step's
  logits within 5e-2 of scale of the forward's, greedy tokens equal
  where the margin is clear, every kernel call made outside a capture
  held against its plain version; (c) all ten registry archs reduced in
  f32 on the card (decode equal to the forward, the same weights on the
  CPU, the window-4 ring buffer, 2 and 1 KV heads; the captured decode
  bit-equal to the eager one); (d) the eager and the replayed step's
  walls in turns over the dry run's roofline, a profile of each, and both
  attention kernels at the LM's shapes beside plain, library (gather +
  SDPA with ``enable_gqa``; SDPA) and bound, on the kernels line as
  ``lm_*``;
* the LM training path (phase 15) — (a) olmo-1b as the registry gives
  it (bf16, 16 layers, d 2048, 16 heads, d_ff 8192, vocab 50304, tied;
  ~1.177 B parameters made on the card from seed 0) trained 8 steps of
  4 x 2048 tokens through ``repro_torch.launch.train.main``, every step
  one replay of the captured train step after its eager first call and
  its capture: finite losses, the last below the first,
  ``flash_attention_bh`` launched twice a layer a step (forward and the
  remat recompute, counted from the config), then the same 8 steps with
  the eager step from the same seed: losses and weights bit-equal (or,
  where two eager runs differ, within their spread); (d) both runs'
  walls, the eager and the replayed step in turns over the dry run's
  roofline, tokens/s and model-flops share, one warm step of each under
  ``torch.profiler``, the AdamW pass, the kernel with its log-sum-exp and
  the plain flash backward at the step's shape (the ``train_*`` fields
  of the kernels line); (b)
  olmo-1b's widths at 2 layers, f32 and bf16: every gradient through
  the kernel forward (each call's out and lse held against plain)
  against the plain forward under autograd; (c) the ten registry archs
  reduced, f32, one train step (``accum`` 2 on llama3-8b) against the
  same weights and batch on the CPU, and three steps through the
  captured train program against three eager steps.
* the LM planner and its dry run (phase 16) — (a) ``choose_strategy`` for
  the ten archs x (train, prefill, decode) on the H100 production mesh
  (16 x 16, shape only) beside the v5e constants', every parameter and
  cache spec dividing its tensor; (b) three steps counted by
  ``repro_torch.launch.dryrun`` on the one-card mesh under
  ``FakeTensorMode`` — olmo-1b's train step at B 4 x S 2048, llama3-8b's
  decode step at B 4 over a 4096-position cache, llama3-8b's prefill of 1
  x 4096 — then built on real weights on the card and run once under the
  same op counter: FLOPs, bytes and kernel units equal to the fake run's,
  launches equal to the config's (32 flash, 32 decode, 32 flash),
  argument bytes equal to the live tensors', the FLOPs within 5% of a
  count from the config, every warm wall (timed without the counter;
  the eager step and, for train and decode, the replayed captured step,
  in turns) at or above the roofline's max(t_compute, t_memory); the
  host cost of the
  counter hook beside a ``torch.library.custom_op``; (c) the production
  dry runs through ``serve.main(["--dry-run", ...])`` and
  ``train.main([..., "--dry-run"])`` under ``tests/test_dryrun.py``'s
  assertions, and both report tables.  16b also counts the ssm and hybrid
  train steps: rwkv6-3b (2 layers) and zamba2-1.2b (7 layers, its shared
  attention block twice, through ``flash_attention_bh``) at full width in
  bf16, B 2 x S 256, folded on fake tensors (the time loops' backward
  folded too) and run on the card with every step of the loops run: FLOPs,
  bytes and kernel units equal.
* the example scripts (phase 17) — ``examples/torch_quickstart.py``,
  ``torch_plan_edge_cnn.py``, ``torch_serve_llm.py`` and
  ``torch_train_lm.py`` run on the card as subprocesses at reduced flags,
  each exiting 0 with its headline printed, every kernel call made
  outside a capture held against its plain version on the same inputs
  (TOL in f32, BF16_TOL in bf16; the LM examples' steps are captured
  programs, whose first call is eager) and each kernel's launches equal
  to the count its plans and
  config give (quickstart: ``kernel_records`` of its two MobileNet plans;
  serving: layers x (prompt + generated) decode calls and a prefill call
  a layer; training: ``train_flash_launches`` a step);
  ``experiments/torch_hillclimb.py``'s pairs A-D, one subprocess a pair
  run beside the examples: every row counted, pair A's chunked rows below
  the recurrent ones in bytes, and pair C's ep and tp rows apart in
  collective bytes, its tp rows above its ep rows in collective time as
  in the reference (pair B has no ep row: granite-moe's 40 experts do not
  divide the model axis, so every row lays its experts out as tp).

All four kernels' launch counters are zeroed just before each path's run
and read just after: they must equal the launches the plan (or the case
list) calls for, computed independently of the counters, on the eager,
the capturing and the replaying runs alike.

Times are taken on the card: the warm ``Session.run`` wall time per model
and the warm per-token decode step, each eager and through the replayed
graphs (medians with their ranges; the device's kernel time and its busy
time, overlapping kernels counted once, from ``torch.profiler``), and each
kernel's device time over the
calls one main-path run makes, replayed as a CUDA graph so host launch
overhead is left out (``conv2d_shard`` also split into its dense and
depthwise calls, and the five call shapes of each CNN/bert kernel that
take the most time), beside the same calls through the plain version,
through one PyTorch library call (``F.conv2d`` after ``F.pad`` where the
pads are asymmetric; ``torch.matmul``; gather by table then
``F.scaled_dot_product_attention``; ``F.scaled_dot_product_attention``)
and the least time the card could take (bytes over 3.35 TB/s or flops
over the peak of the input type, whichever is larger; f32 attention at
the 3xTF32 rate of its tensor-core route, 495 / 3 TFLOP/s).  Phase 8 also
names the SDPA backend that served each case, the kernel's blocks per
wave of the card, and checks that two calls give the same bits.  Phase 5
also times the paged decode kernel at long context (``LONG_DECODE``: 4
and 16 heads, hd 128, kv_len 4096) against its bytes bound, the plain
version and gather + SDPA, and phase 7 prints the decode kernel's
split-KV launch shape (blocks, cluster size, waves) at the main path's.
The decode calls are timed as the captured step makes them, with
``kv_len`` read from device memory; phase 5 holds that path bit-equal to
the by-value one.

Output: progress lines, the card's name and power limit from nvidia-smi, a
``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
that line.  Without a CUDA device, or outside a checkout, it exits
non-zero and prints no result.
"""
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-4                      # scale-normalised; f32 sums in other orders
PEAK_F32_FLOPS = 67e12          # H100 SXM, CUDA cores, f32 (data sheet)
PEAK_BF16_FLOPS = 989e12        # H100 SXM, tensor cores, bf16 dense
#: f32 attention runs 3xTF32 (three TF32 products per product) on the
#: tensor cores: 495 TFLOP/s TF32 dense over 3
PEAK_3XTF32_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12            # H100 SXM HBM3 (data sheet)
NODES = 4
MAIN_MODELS = (("mobilenet", {}), ("resnet18", {}), ("bert", {}))
TIMED_REPS = 20
SESSION_REPS = 7                # warm Session.run timings per path
DECODE_REPS = 3                 # replays of the ~33k recorded decode calls
#: OLMo-1B's widths and depth (registry olmo-1b) in the decode block
OLMO = dict(n_layers=16, d_model=2048, n_heads=16, d_ff=8192, vocab=50304)
PROMPT_LEN, N_NEW, PAGE_SIZE, CAPACITY = 480, 32, 16, 512
#: ops.flash_attention at full width: name, B, H, KV, S, hd, causal,
#: window, dtype
FLASH_CASES = (
    ("olmo-1b prefill", 1, 16, 16, 2048, 128, True, None, "float32"),
    ("llama3-8b gqa", 1, 32, 8, 2048, 128, True, None, "float32"),
    ("llama3-8b gqa bf16", 1, 32, 8, 2048, 128, True, None, "bfloat16"),
    ("zamba2-1.2b window", 1, 32, 32, 8192, 64, True, 4096, "float32"),
    ("unaligned non-causal", 1, 16, 16, 2000, 128, False, None, "float32"),
)
BF16_TOL = 2e-2                 # the reference's bf16 tolerance
#: dense conv shards of the 4-node main path with few output pixels:
#: rows, width, cin, cout, k, stride, padding of the layer
SKINNY_CONVS = (
    (4, 7, 512, 512, 3, 1, 1),      # resnet18 layer4, 14 output pixels
    (2, 7, 512, 512, 3, 1, 1),      # resnet18 layer4, 7 output pixels
    (6, 14, 256, 256, 3, 1, 1),     # resnet18 layer3
    (5, 14, 256, 512, 3, 2, 1),     # resnet18 layer4 transition
    (2, 7, 1024, 1024, 1, 1, 0),    # mobilenet pw13
)
#: FC shapes of phase 2: m, cin, cout (bert-base's whole sequence and
#: 4-node shards, the classifier heads)
FC_SHAPES = ((128, 768, 2304), (128, 2304, 768), (128, 768, 3072),
             (128, 3072, 768), (32, 768, 2304), (32, 2304, 768),
             (32, 768, 3072), (32, 3072, 768), (1, 1024, 1000),
             (1, 512, 1000), (1, 2048, 1000), (1, 200, 100))
TOP_SHAPES = 5                  # recorded call shapes printed per kernel
STAGES_SHOWN = 4                # instrumented mesh stages printed per run
DECODE_TOL = 1e-5               # the reference's decode-kernel tolerance
#: long-context paged decode, where bytes set the pace: heads, hd, page
#: size, kv_len (a full table of kv_len / page size pages)
LONG_DECODE = ((4, 128, 16, 4096), (16, 128, 16, 4096))
#: the pools a long-context case rotates through, so that one pass reads
#: more than the card's 50 MB of L2 and each call finds its pages cold
LONG_DECODE_BYTES = 160 * 2 ** 20


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def rel_err(a, b) -> float:
    """Max abs deviation over the reference's scale (at least 1)."""
    if a.shape != b.shape:
        return float("inf")
    if b.numel() == 0:
        return 0.0
    scale = max(1.0, float(b.abs().max()))
    return float((a.float() - b.float()).abs().max()) / scale


def abs_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if b.numel() else 0.0


def kernel_wrappers() -> dict:
    """Every kernel's wrapper (each keeps its ``launches`` counter)."""
    from repro_torch.kernels.conv2d import conv2d_shard
    from repro_torch.kernels.flash_attention import (flash_attention_bh,
                                                     flash_decode_paged)
    from repro_torch.kernels.ops import matmul_tiled
    return {"conv2d_shard": conv2d_shard, "matmul_tiled": matmul_tiled,
            "flash_decode_paged": flash_decode_paged,
            "flash_attention_bh": flash_attention_bh}


def zero_counts() -> None:
    for f in kernel_wrappers().values():
        f.launches = 0
        for route in getattr(f, "routes", {}):
            f.routes[route] = 0


def read_counts() -> dict:
    return {name: f.launches for name, f in kernel_wrappers().items()}


SHARD_KERNELS = ("conv2d_shard", "matmul_tiled")


def read_routes(names=SHARD_KERNELS) -> dict:
    """Launches by route (``routes``) of the wrappers ``names``: by
    default the two shard kernels' loops."""
    wrappers = kernel_wrappers()
    return {name: dict(wrappers[name].routes) for name in names}


def decode_routes() -> dict:
    """The paged decode kernel's launches by route: ``per_row`` (groups =
    1) and ``grouped``."""
    return read_routes(("flash_decode_paged",))["flash_decode_paged"]


def check_decode_routes(path, since, per_row, grouped) -> None:
    """Since ``since`` (an earlier :func:`decode_routes`), the decode
    kernel took the per-row route ``per_row`` times and the grouped one
    ``grouped`` times."""
    now = decode_routes()
    got = {r: now[r] - since.get(r, 0) for r in now}
    want = {"per_row": per_row, "grouped": grouped}
    check(got == want, f"{path}: flash_decode_paged launches by route "
          f"{got} != {want}")


def routes_text(routes) -> str:
    return "; ".join(f"{k} " + ", ".join(f"{r} {n}" for r, n in v.items())
                     for k, v in routes.items())


def half_routes(conv_calls, mm_calls) -> dict:
    """The launches by loop that same-type 2-byte calls of the two shard
    kernels must show, from the recorded calls (x, w, kwargs[, out]):
    every dense call and every FC call on the tensor cores."""
    dw = sum(bool(c[2].get("depthwise")) for c in conv_calls)
    return {"conv2d_shard": {"tensor_cores": len(conv_calls) - dw,
                             "cuda_cores": 0, "depthwise": dw},
            "matmul_tiled": {"tensor_cores": len(mm_calls),
                             "cuda_cores": 0}}


def check_routes(path, routes, want) -> None:
    check(routes == want, f"{path}: launches by loop {routes} != {want}")


def check_counts(path, counts, want) -> None:
    """``counts`` equal ``want`` for the kernels it names, 0 for the rest."""
    full = {name: want.get(name, 0) for name in counts}
    check(counts == full, f"{path}: kernel launches {counts} != {full}")


# ---------------------------------------------------------------------------
# Expected kernel records of a plan (independent of the launch counters)
# ---------------------------------------------------------------------------

def cell_launches(layers, a, b, need, in_rect):
    """(conv, fc) kernel launches of one segment program over ``[a..b]``
    computing the regions ``need`` from the input rect ``in_rect``: its
    non-degenerate conv-family and FC records."""
    from repro_torch.core.graph import ConvT
    from repro_torch.kernels.conv2d import shard_out_shape
    from repro_torch.runtime.engine import _segment_records

    counts = [0, 0]
    recs = _segment_records(layers, a, b, need, in_rect)
    rows = in_rect[0][1] - in_rect[0][0]
    for li, (t, k, s, pads, sl, chans) in zip(range(a, b + 1), recs):
        t = ConvT(t)
        width = chans[1] - chans[0]
        if t == ConvT.FC:
            counts[1] += rows > 0 and width > 0
        elif t in (ConvT.CONV, ConvT.POINTWISE, ConvT.DWCONV):
            oh, ow = shard_out_shape(sl[1] - sl[0], sl[3] - sl[2], k, s,
                                     pads)
            cout = width if t != ConvT.DWCONV else layers[li].in_c
            counts[0] += oh > 0 and ow > 0 and cout > 0
        rows = need[li][0][1] - need[li][0][0]
    return counts


def plan_records(graph, plan, branch_counts):
    """(conv, fc) launches of ``plan``: ``branch_counts(layers, steps)``
    summed over the chain, or over the branches of a DAG less each merge
    layer (a merge runs no kernel)."""
    layers = graph.layers
    if graph.is_chain:
        return tuple(branch_counts(layers, plan.steps))
    counts = [0, 0]
    for br in graph.linearize():
        ids = list(br.ids)
        rest = ids[1:] if graph.fan_in(ids[0]) >= 2 else ids
        if rest:
            c = branch_counts([layers[i] for i in rest],
                              [plan.steps[i] for i in rest])
            counts = [counts[0] + c[0], counts[1] + c[1]]
    return tuple(counts)


def kernel_records(graph, plan, nodes):
    """(conv, fc) counts of the non-degenerate conv-family and FC records
    that the local executor hands to the kernels for ``plan``."""
    from repro_torch.core.plan import steps_segments
    from repro_torch.runtime.engine import backward_chain, exact_regions

    def branch(layers, steps):
        counts = [0, 0]
        for a, b in steps_segments(steps):
            for cells in exact_regions(layers[b], steps[a][0], nodes):
                for reg in cells:
                    need, in_rect = backward_chain(layers, a, b, reg)
                    c = cell_launches(layers, a, b, need, in_rect)
                    counts = [counts[0] + c[0], counts[1] + c[1]]
        return counts
    return plan_records(graph, plan, branch)


def mesh_kernel_records(graph, plan, nodes, overlap):
    """(conv, fc) launches of one mesh run of ``plan``: as the local
    executor's, except that with ``overlap`` every segment whose exit
    boundary takes the halo exchange (``permute_plan``, halo rows on some
    side) runs each node's cell as its up to three strip programs (top,
    interior, bottom: ``strip_regions``)."""
    from repro_torch.core.plan import steps_segments
    from repro_torch.runtime.engine import backward_chain, exact_regions
    from repro_torch.runtime.mesh_exec import permute_plan, strip_regions

    def branch(layers, steps):
        counts = [0, 0]
        segs = steps_segments(steps)
        for si, (a, b) in enumerate(segs):
            regs = exact_regions(layers[b], steps[a][0], nodes)
            rp = None
            if overlap and si + 1 < len(segs):
                a2, b2 = segs[si + 1]
                rp = permute_plan(layers, regs, a2, b2, steps[a][0],
                                  steps[a2][0], nodes)
            for cells in regs:
                for reg in cells:
                    need, in_rect = backward_chain(layers, a, b, reg)
                    parts = [need]
                    if rp is not None and (rp.h_up or rp.h_dn):
                        parts = [backward_chain(layers, a, b, strip)[0]
                                 for strip in strip_regions(reg, rp)
                                 if strip is not None]
                    for part in parts:
                        c = cell_launches(layers, a, b, part, in_rect)
                        counts = [counts[0] + c[0], counts[1] + c[1]]
        return counts
    return plan_records(graph, plan, branch)


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def graph_ms(fn, reps=TIMED_REPS) -> float:
    """Device time of ``fn`` (a sequence of launches) per call: captured
    once as a CUDA graph after a warm-up on a side stream, then replayed
    ``reps`` times between CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(run, reps):
    """What the card ran over ``reps`` calls of ``run``, from
    ``torch.profiler`` (CUPTI, kernels inside replayed graphs included):
    (kernels a call, kernel ms a call, busy ms a call, {kernel name: ms a
    call}).  Kernel ms sums every kernel's time; busy ms is the union of
    the kernels' intervals, which counts once the time that kernels on
    concurrent streams (the mesh's nodes) overlap.  No kernel seen gives
    (0, None, None, {}), printed as not measured."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    by_name, n = {}, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            by_name[e.key] = e.self_device_time_total / 1e3 / reps
            n += e.count
    if not n:
        return 0, None, None, {}
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return n / reps, sum(by_name.values()), busy / 1e3 / reps, by_name


def profile_text(kernels, dev_ms, busy_ms, wall_ms) -> str:
    """A device profile beside the wall time it belongs to; the idle share
    is of the busy time."""
    if dev_ms is None:
        return "device time not measured (the profiler saw no kernel)"
    return (f"{kernels:.0f} kernels, {dev_ms:.3f} ms of kernel time a call "
            f"and the device busy {busy_ms:.3f} ms of it (overlapping "
            f"kernels counted once), the device idle "
            f"{max(0.0, 1 - busy_ms / wall_ms) * 100:.1f}% of the "
            f"{wall_ms:.3f} ms median wall")


def library_conv(x, w, pads, stride, depthwise):
    """One PyTorch library call for the conv shard (cuDNN): F.conv2d with
    its own padding when the pads are symmetric, after F.pad otherwise."""
    import torch.nn.functional as F
    pt, pb, pl_, pr = pads
    xn = x.permute(2, 0, 1)[None]
    wn = w.permute(3, 2, 0, 1)
    groups = x.shape[-1] if depthwise else 1
    if pt == pb and pl_ == pr:
        return F.conv2d(xn, wn, stride=stride, padding=(pt, pl_),
                        groups=groups)
    return F.conv2d(F.pad(xn, (pl_, pr, pt, pb)), wn, stride=stride,
                    groups=groups)


def nbytes_of(*tensors) -> float:
    """Bytes of the tensors at their element sizes: each read or written
    once."""
    return float(sum(t.numel() * t.element_size() for t in tensors))


def conv_work(x, w, out, depthwise):
    """(bytes, flops) one conv shard call must move and do."""
    k = w.shape[0]
    ho, wo, cout = out.shape
    cin = x.shape[2]
    flops = 2.0 * ho * wo * cout * k * k * (1 if depthwise else cin)
    return nbytes_of(x, w, out), flops


def matmul_work(x, w, out):
    m, k = x.shape
    return nbytes_of(x, w, out), 2.0 * m * k * w.shape[1]


def bound_ms(nbytes, flops, peak_flops=PEAK_F32_FLOPS):
    """The least time for the work: bytes over the memory rate or flops
    over ``peak_flops`` (f32 on CUDA cores by default), the larger."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def grid_geometries():
    """Each conv geometry (type, k, stride, padding) of the edge models at
    its first full-width layer."""
    from repro_torch.configs.edge_models import EDGE_MODELS
    from repro_torch.core.graph import ConvT
    first = {}
    for name, f in EDGE_MODELS.items():
        for l in f().layers:
            if l.conv_t in (ConvT.CONV, ConvT.POINTWISE, ConvT.DWCONV):
                first.setdefault((l.conv_t, l.k, l.s, l.p), l)
    return sorted(first.items())


def conv_grid_cases(dev, gen, xd=None, wd=None):
    """The full-width conv shards of phase 2 in dtypes ``xd`` and ``wd``
    (default f32): every geometry at its first full-width layer x every
    shard pad signature x (a strided view, a contiguous input), dense
    weights as an OutC channel view; then the ``SKINNY_CONVS`` shapes.
    Yields (description, x, w, kwargs); the first count of cases is the
    geometries'."""
    import torch
    from repro_torch.core.graph import ConvT, shard_halo_pads
    from repro_torch.kernels.conv2d import shard_out_shape
    xd = xd or torch.float32
    wd = wd or torch.float32
    for (t, k, s, p), l in grid_geometries():
        dw = t == ConvT.DWCONV
        if dw:
            w = torch.randn((k, k, 1, l.in_c), generator=gen,
                            device=dev).to(wd)
        else:
            w = (torch.randn((k, k, l.in_c, l.out_c + 3), generator=gen,
                             device=dev)
                 / (k * k * l.in_c) ** 0.5).to(wd)[..., 1:1 + l.out_c]
        for pads in shard_halo_pads(p):
            big = torch.randn((l.in_h + 2, l.in_w + 2, l.in_c + 1),
                              generator=gen, device=dev).to(xd)
            view = big[1:1 + l.in_h, 2:2 + l.in_w, :l.in_c]
            for x in (view, view.contiguous()):
                yield (f"{t.name} k{k} s{s} p{p} pads={pads}", x, w,
                       dict(pads=pads, stride=s, depthwise=dw))
    for rows, width, cin, cout, k, s, p in SKINNY_CONVS:
        w = (torch.randn((k, k, cin, cout), generator=gen, device=dev)
             / (k * k * cin) ** 0.5).to(wd)
        big = torch.randn((rows + 2, width + 2, cin), generator=gen,
                          device=dev).to(xd)
        view = big[1:1 + rows, 1:1 + width]
        for pads in shard_halo_pads(p):
            if min(shard_out_shape(rows, width, k, s, pads)) <= 0:
                continue
            for x in (view, view.contiguous()):
                yield (f"[{rows},{width},{cin}] k{k} s{s} -> {cout} "
                       f"pads={pads}", x, w, dict(pads=pads, stride=s))


def fc_grid_cases(dev, gen, xd=None, wd=None):
    """The FC shapes of phase 2 (bert-base's whole sequence and 4-node
    shards, the classifier heads), each with its whole weight and a
    4-node column view: (description, x, w)."""
    import torch
    xd = xd or torch.float32
    wd = wd or torch.float32
    for m, cin, cout in FC_SHAPES:
        x = torch.randn((m, cin), generator=gen, device=dev).to(xd)
        w = (torch.randn((cin, cout), generator=gen, device=dev)
             / cin ** 0.5).to(wd)
        share = -(-cout // NODES)
        for wv in (w, w[:, share:2 * share]):
            yield f"[{m},{cin}]@{tuple(wv.shape)}", x, wv


def phase_kernel_grid(dev, errs):
    """Each kernel against its plain version on the card at the shapes of
    the edge models: every conv geometry at its first full-width layer x
    every shard pad signature (strided-view and contiguous inputs, and a
    channel-view weight), the skinny shard shapes of ``SKINNY_CONVS``, and
    the bert-base (whole sequence and 4-node shards) and classifier-head
    FC shapes (whole and column-sliced weights)."""
    import torch
    from repro_torch.kernels.conv2d import conv2d_shard
    from repro_torch.kernels.ops import matmul_tiled
    from repro_torch.kernels.ref import conv2d_shard_ref, matmul_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    n = n_first = 0
    n_geoms = len(grid_geometries())
    for desc, x, w, kw in conv_grid_cases(dev, gen):
        out = conv2d_shard(x, w, **kw)
        ref = conv2d_shard_ref(x, w, **kw)
        torch.cuda.synchronize()
        e = rel_err(out, ref)
        check(e < TOL, f"conv2d_shard {desc}: scale-normalised error {e}")
        errs["conv2d_shard"] = max(errs["conv2d_shard"], abs_err(out, ref))
        n += 1
        n_first += not desc.startswith("[")
    print(f"phase 2: conv2d_shard == plain on {n} full-width cases "
          f"({n_first} over {n_geoms} geometries x pad signatures x 2 "
          f"layouts, {n - n_first} over {len(SKINNY_CONVS)} skinny shard "
          f"shapes); max abs err {errs['conv2d_shard']:.3g}", flush=True)
    n = 0
    for desc, x, wv in fc_grid_cases(dev, gen):
        out = matmul_tiled(x, wv)
        ref = matmul_ref(x, wv)
        torch.cuda.synchronize()
        e = rel_err(out, ref)
        check(e < TOL, f"matmul_tiled {desc}: scale-normalised error {e}")
        errs["matmul_tiled"] = max(errs["matmul_tiled"], abs_err(out, ref))
        n += 1
    print(f"phase 2: matmul_tiled == plain on {n} FC shapes; max abs err "
          f"{errs['matmul_tiled']:.3g}", flush=True)


# ---------------------------------------------------------------------------
# bf16 and fp16: the one-ulp rule
# ---------------------------------------------------------------------------

#: how far two f32 sums of one set of terms, taken in other orders (or
#: with and without fused multiply-adds), may be apart, as a share of the
#: sum of the terms' magnitudes: each rounding moves a sum by at most an
#: ulp of a partial sum, so a 9-term depthwise sum by up to ~2^-20.8 of
#: it (the long dense sums of phase 2 stay within 2^-22 on an H100)
SUM_SLACK = 2.0 ** -20
#: (x dtype, w dtype) pairs of phase 2's half grid beyond bf16 and fp16
#: alone: a half x with f32 weights (the kernel's own), then two that the
#: wrapper reaches through an exact upcast of the weight
MIXED_PAIRS = (("bfloat16", "float32"), ("float16", "float32"),
               ("float32", "bfloat16"), ("bfloat16", "float16"))


def ulps(a, b):
    """Units in the last place between two tensors of one floating dtype:
    the distance of their bit patterns in the dtype's order."""
    import torch
    bits = {2: torch.int16, 4: torch.int32}[a.element_size()]
    sign = 1 << (8 * a.element_size() - 1)

    def order(t):
        i = t.contiguous().view(bits).long()
        return torch.where(i < 0, -(i & (sign - 1)), i)
    return (order(a) - order(b)).abs()


def new_ulp_stats() -> dict:
    return dict(calls=0, elems=0, differ=0, max_ulp=0, cancel=0)


def hold_ulp(what, out, plain, mag, stats) -> None:
    """``out`` (the kernel's) in ``plain``'s dtype and within one ulp of it
    at every element, save where the element cancels (its two f32 sums
    may be more than one of its ulps apart): there within SUM_SLACK of
    ``mag``, the f32 sum of |x * w| over its terms.  Both versions read
    every element as f32, sum in f32 in their own orders and round
    once.  Adds the call to ``stats``: elements, elements that differ,
    the largest ulps, the cancellations past one ulp."""
    check(out.dtype == plain.dtype and out.shape == plain.shape,
          f"{what}: {out.dtype} {tuple(out.shape)} against plain "
          f"{plain.dtype} {tuple(plain.shape)}")
    u = ulps(out, plain)
    diff = (out.float() - plain.float()).abs()
    near = diff <= SUM_SLACK * mag.float()
    bad = (u > 1) & ~near
    top = int(u.max()) if u.numel() else 0
    if bool(bad.any()):
        share = float((diff[bad] / mag.float()[bad]).max())
        raise SmokeFailure(
            f"{what}: {int(bad.sum())} of {u.numel()} elements past one ulp "
            f"of plain (largest {top} ulps) and {share:.3g} of their "
            f"|x * w| sum apart (slack {SUM_SLACK:.3g})")
    stats["calls"] += 1
    stats["elems"] += u.numel()
    stats["differ"] += int((u > 0).sum())
    stats["max_ulp"] = max(stats["max_ulp"], top)
    stats["cancel"] += int((u > 1).sum())


def conv_mag(x, w, kw):
    """The f32 sum of |x * w| over each output element's terms."""
    from repro_torch.kernels.ref import conv2d_shard_ref
    return conv2d_shard_ref(x.float().abs(), w.float().abs(), **kw)


def ulp_text(st) -> str:
    return (f"{st['calls']} calls, the largest difference {st['max_ulp']} "
            f"ulps, {st['differ']} of {st['elems']} elements "
            f"({st['differ'] / max(1, st['elems']) * 100:.4f}%) differ, "
            f"{st['cancel']} past one ulp, each within {SUM_SLACK:.3g} of "
            f"its sum of |x * w| (a cancellation; in an f32 output, the "
            f"two f32 sums' orders)")


def phase_kernel_grid_half(dev, ulp):
    """Phase 2 in bf16 and fp16: every case of :func:`conv_grid_cases` and
    :func:`fc_grid_cases` with both operands in the dtype, and the
    ``MIXED_PAIRS`` at each geometry's first pad signature (both layouts),
    the skinny shapes' and the FC shapes; each call's output in x's dtype,
    within one ulp of the plain version (:func:`hold_ulp`), one launch a
    call, on its loop: the tensor cores for a same-type pair's dense and
    FC calls, CUDA cores for the mixed pairs'.  ``ulp`` gathers the counts
    per kernel and dtype pair."""
    import torch
    from repro_torch.kernels.conv2d import conv2d_shard
    from repro_torch.kernels.ops import matmul_tiled
    from repro_torch.kernels.ref import conv2d_shard_ref, matmul_ref

    gen = torch.Generator(device=dev).manual_seed(2)
    pairs = [(d, d) for d in ("bfloat16", "float16")] + list(MIXED_PAIRS)
    t0 = time.perf_counter()
    for xd, wd in pairs:
        mixed = xd != wd
        xt, wt = getattr(torch, xd), getattr(torch, wd)
        # the dense loop: same-type 2-byte pairs on the tensor cores, the
        # mixed pairs (f32 weights, or upcast to them) on CUDA cores
        dense = "cuda_cores" if mixed else "tensor_cores"
        before = read_routes()
        seen = set()
        st = ulp.setdefault(("conv2d_shard", xd, wd), new_ulp_stats())
        for desc, x, w, kw in conv_grid_cases(dev, gen, xt, wt):
            head = desc.split(" pads=")[0]
            if mixed and (head, x.is_contiguous()) in seen:
                continue
            seen.add((head, x.is_contiguous()))
            route = "depthwise" if kw.get("depthwise") else dense
            n0, r0 = conv2d_shard.launches, conv2d_shard.routes[route]
            out = conv2d_shard(x, w, **kw)
            check(conv2d_shard.launches == n0 + 1
                  and conv2d_shard.routes[route] == r0 + 1,
                  f"conv2d_shard {xd} x {wd} {desc}: not one launch on "
                  f"{route}")
            hold_ulp(f"conv2d_shard {xd} x {wd} {desc}", out,
                     conv2d_shard_ref(x, w, **kw), conv_mag(x, w, kw), st)
        stm = ulp.setdefault(("matmul_tiled", xd, wd), new_ulp_stats())
        for desc, x, wv in fc_grid_cases(dev, gen, xt, wt):
            n0, r0 = matmul_tiled.launches, matmul_tiled.routes[dense]
            out = matmul_tiled(x, wv)
            check(matmul_tiled.launches == n0 + 1
                  and matmul_tiled.routes[dense] == r0 + 1,
                  f"matmul_tiled {xd} x {wd} {desc}: not one launch on "
                  f"{dense}")
            hold_ulp(f"matmul_tiled {xd} x {wd} {desc}", out,
                     matmul_ref(x, wv), x.float().abs() @ wv.float().abs(),
                     stm)
        torch.cuda.synchronize()
        for kname, s in (("conv2d_shard", st), ("matmul_tiled", stm)):
            print(f"phase 2: {kname} x {xd}, w {wd} (out {xd}) == plain "
                  f"within one ulp: {ulp_text(s)}", flush=True)
        routes = {k: {r: n - before[k][r] for r, n in v.items()}
                  for k, v in read_routes().items()}
        print(f"phase 2: x {xd}, w {wd}: launches by loop: "
              f"{routes_text(routes)}", flush=True)
    print(f"phase 2: the half grid took {time.perf_counter() - t0:.1f} s",
          flush=True)


def wall_ms(run, reps):
    """Host-clock ms of ``reps`` synchronised calls of ``run``."""
    import torch
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def walls_in_turns(runs, reps):
    """Host-clock ms of ``reps`` synchronised calls of each callable in
    ``runs`` (name: callable), taken in turns, the order reversed every
    other round (a b, b a, a b, ...), so that the host's drift falls on
    all of them alike: {name: [ms, ...]}."""
    import torch
    names = list(runs)
    walls = {n: [] for n in names}
    for i in range(reps):
        for n in (names if i % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[n]()
            torch.cuda.synchronize()
            walls[n].append((time.perf_counter() - t0) * 1e3)
    return walls


def spread(walls):
    """(median, min, max) of a list of times."""
    w = sorted(walls)
    return w[len(w) // 2], w[0], w[-1]


def phase_main_path(dev, name, kw, seed, totals, errs, card):
    """plan_search -> Session(backend="cuda").run on one model at full
    width, through the captured segment programs (``jit_segments``, the
    default: eager, then captured, then replayed) and through the eager
    records; returns the per-kernel timing row of this model."""
    import torch
    from repro_torch import (AnalyticEstimator, ExecConfig, Session,
                             Testbed, init_weights, plan_search,
                             run_reference)
    from repro_torch.configs.edge_models import EDGE_MODELS
    from repro_torch.kernels.conv2d import conv2d_shard
    from repro_torch.kernels.ops import matmul_tiled
    from repro_torch.kernels.ref import conv2d_shard_ref, matmul_ref
    from repro_torch.runtime import engine

    g = EDGE_MODELS[name](**kw)
    ws = init_weights(g, torch.Generator().manual_seed(seed), dev)
    l0, ll = g.layers[0], g.layers[-1]
    x = torch.randn((l0.in_h, l0.in_w, l0.in_c),
                    generator=torch.Generator().manual_seed(seed + 1)
                    ).to(dev)
    t0 = time.perf_counter()
    res = plan_search(g, AnalyticEstimator(),
                      Testbed(nodes=NODES, bandwidth_gbps=0.5))
    plan_s = time.perf_counter() - t0
    plan = res.plan
    want = kernel_records(g, plan, NODES)
    n_nt = sum(1 for _, m in plan.steps if int(m) == 1)
    schemes = sorted({s.name for s, _ in plan.steps})
    want_counts = {"conv2d_shard": want[0], "matmul_tiled": want[1]}
    sess_k = Session(g, ws, plan, NODES, ExecConfig(backend="cuda"))
    sess_e = Session(g, ws, plan, NODES,
                     ExecConfig(backend="cuda", jit_segments=False))
    sess_t = Session(g, ws, plan, NODES, ExecConfig(backend="torch"))

    engine.clear_segment_cache()
    zero_counts()
    out_e, st_e = sess_e.run(x)
    torch.cuda.synchronize()
    check_counts(f"{name} (eager records)", read_counts(), want_counts)
    # the main path: the segment programs' first run (eager), second
    # (captured) and third (replayed), each counted on its own
    for run in ("eager", "capture", "replay"):
        zero_counts()
        out_k, st_k = sess_k.run(x)
        torch.cuda.synchronize()
        counts = read_counts()
        check_counts(f"{name} ({run} run)", counts, want_counts)
        check(torch.equal(out_k, out_e),
              f"{name}: {run} run of the segment programs differs from "
              f"jit_segments=False by {abs_err(out_k, out_e)}")
        check(st_k == st_e, f"{name}: {run} run ExecStats {st_k} != "
                            f"{st_e}")
    info = engine.segment_cache_info()
    got = (counts["conv2d_shard"], counts["matmul_tiled"])
    totals["conv2d_shard"] += got[0]
    totals["matmul_tiled"] += got[1]

    out_t, st_t = sess_t.run(x)
    ref = run_reference(g, ws, x)
    torch.cuda.synchronize()
    check(tuple(out_k.shape) == (ll.out_h, ll.out_w, ll.out_c),
          f"{name}: output shape {tuple(out_k.shape)}")
    check(bool(torch.isfinite(out_k).all()), f"{name}: non-finite output")
    e_ref = rel_err(out_k, ref)
    e_t = rel_err(out_t, ref)
    check(e_ref < TOL, f"{name}: cuda backend vs reference {e_ref}")
    check(e_t < TOL, f"{name}: torch backend vs reference {e_t}")
    check(st_k == st_t, f"{name}: ExecStats {st_k} != {st_t}")
    print(f"phase 3: {name}: plan {len(plan)} layers, schemes {schemes}, "
          f"{n_nt} NT-fused, cost {res.cost:.6g} s (searched in "
          f"{plan_s:.3f} s); launches conv2d_shard={got[0]} "
          f"matmul_tiled={got[1]} == plan records on the eager-records, "
          f"eager, capture and replay runs; the three runs' outputs "
          f"bit-equal to jit_segments=False, ExecStats equal; "
          f"segment_cache_info {tuple(info)}; err vs reference "
          f"{e_ref:.3g} (torch backend {e_t:.3g}); {st_k}", flush=True)

    # warm end-to-end wall time, eager records and replayed programs in
    # turns, after the capture
    walls = {"eager": [], "graph": []}
    for _ in range(SESSION_REPS):
        walls["eager"] += wall_ms(lambda: sess_e.run(x), 1)
        walls["graph"] += wall_ms(lambda: sess_k.run(x), 1)

    # record the kernel calls of one run, then time them three ways
    calls = {"conv2d_shard": [], "matmul_tiled": []}
    prof = {"eager": device_profile(lambda: sess_e.run(x), 3),
            "graph": device_profile(lambda: sess_k.run(x), 3)}

    engine.conv2d_shard, engine.matmul_tiled = recorders(calls)
    try:
        sess_e.run(x)   # a replayed program calls no wrapper
    finally:
        engine.conv2d_shard, engine.matmul_tiled = conv2d_shard, matmul_tiled
    torch.cuda.synchronize()
    engine.clear_segment_cache()

    conv_calls = calls["conv2d_shard"]
    mm_calls = calls["matmul_tiled"]
    row = {"model": name, "eager_ms": spread(walls["eager"]),
           "graph_ms": spread(walls["graph"]),
           "mesh_inputs": (g, ws, x, plan, out_k, st_k, ref,
                           call_shapes(conv_calls, mm_calls))}
    check_recorded(name, conv_calls, mm_calls, errs)
    if conv_calls:
        nbytes = flops = 0.0
        for xs, w, kwargs, out in conv_calls:
            b, f = conv_work(xs, w, out, kwargs.get("depthwise", False))
            nbytes += b
            flops += f
        row["conv2d_shard"] = dict(
            calls=len(conv_calls), bytes=nbytes, flops=flops,
            ms=graph_ms(lambda: [conv2d_shard(a, b, **c)
                                 for a, b, c, _ in conv_calls]),
            plain_ms=graph_ms(lambda: [conv2d_shard_ref(a, b, **c)
                                       for a, b, c, _ in conv_calls]),
            library_ms=graph_ms(lambda: [
                library_conv(a, b, c["pads"], c["stride"],
                             c.get("depthwise", False))
                for a, b, c, _ in conv_calls]))
    if mm_calls:
        nbytes = flops = 0.0
        for xs, w, out in mm_calls:
            b, f = matmul_work(xs, w, out)
            nbytes += b
            flops += f
        row["matmul_tiled"] = dict(
            calls=len(mm_calls), bytes=nbytes, flops=flops,
            ms=graph_ms(lambda: [matmul_tiled(a, b)
                                 for a, b, _ in mm_calls]),
            plain_ms=graph_ms(lambda: [matmul_ref(a, b)
                                       for a, b, _ in mm_calls]),
            library_ms=graph_ms(lambda: [torch.matmul(a, b)
                                         for a, b, _ in mm_calls]))
    if conv_calls:
        split = {}
        for label, dw in (("dense", False), ("depthwise", True)):
            cs = [c for c in conv_calls if c[2].get("depthwise", False) == dw]
            if cs:
                split[label] = dict(
                    calls=len(cs),
                    ms=graph_ms(lambda: [conv2d_shard(a, b, **c)
                                         for a, b, c, _ in cs]),
                    library_ms=graph_ms(lambda: [
                        library_conv(a, b, c["pads"], c["stride"], dw)
                        for a, b, c, _ in cs]))
        row["conv2d_shard"]["split"] = split
        print(f"phase 4: {name}: conv2d_shard by kind: " + "; ".join(
            f"{k} {v['calls']} calls {v['ms']:.4f} ms (library "
            f"{v['library_ms']:.4f})" for k, v in split.items())
            + f" [{card}]", flush=True)
    top_shapes(name, conv_calls, mm_calls, card)
    (em, elo, ehi), (gm, glo, ghi) = row["eager_ms"], row["graph_ms"]
    parts = [f"phase 4: {name}: warm Session.run jit_segments=False "
             f"{em:.3f} ms (range {elo:.3f}-{ehi:.3f}), jit_segments=True "
             f"(replayed graphs) {gm:.3f} ms (range {glo:.3f}-{ghi:.3f}); "
             f"medians of {SESSION_REPS} synchronised runs each, in turns; "
             f"profiled: eager records "
             f"{profile_text(*prof['eager'][:3], em)}; replayed graphs "
             f"{profile_text(*prof['graph'][:3], gm)}"]
    for kname in ("conv2d_shard", "matmul_tiled"):
        r = row.get(kname)
        if r:
            bm, by = bound_ms(r["bytes"], r["flops"])
            parts.append(
                f"{kname}: {r['calls']} calls, {r['ms']:.4f} ms "
                f"(plain {r['plain_ms']:.4f}, library "
                f"{r['library_ms']:.4f}, bound {bm:.4f} by {by}; "
                f"{r['flops'] / 1e9:.3f} GFLOP, {r['bytes'] / 1e6:.2f} MB)")
    print("; ".join(parts) + f" [{card}]", flush=True)
    return row


def call_shapes(conv_calls, mm_calls) -> set:
    """The distinct shapes (kernel, input, weight, arguments) of recorded
    calls."""
    return ({("conv2d_shard", tuple(a.shape), tuple(b.shape),
              tuple(sorted((k, str(v)) for k, v in c.items())))
             for a, b, c, _ in conv_calls}
            | {("matmul_tiled", tuple(a.shape), tuple(b.shape), ())
               for a, b, _ in mm_calls})


def check_recorded(name, conv_calls, mm_calls, errs) -> None:
    """Hold every recorded kernel call against its plain version on the
    same inputs (scale-normalised TOL) and keep each kernel's largest
    absolute difference in ``errs``."""
    from repro_torch.kernels.ref import conv2d_shard_ref, matmul_ref
    for xs, w, kwargs, out in conv_calls:
        plain = conv2d_shard_ref(xs, w, **kwargs)
        check(rel_err(out, plain) < TOL, f"{name}: recorded conv call")
        errs["conv2d_shard"] = max(errs["conv2d_shard"], abs_err(out, plain))
    for xs, w, out in mm_calls:
        plain = matmul_ref(xs, w)
        check(rel_err(out, plain) < TOL, f"{name}: recorded FC call")
        errs["matmul_tiled"] = max(errs["matmul_tiled"], abs_err(out, plain))


def recorders(calls):
    """Stand-ins for the engine's conv2d_shard and matmul_tiled that call
    the wrappers (so launches count as before) and record each call's
    inputs and output in ``calls``."""
    from repro_torch.kernels.conv2d import conv2d_shard
    from repro_torch.kernels.ops import matmul_tiled

    def rec_conv(xs, w, **kwargs):
        out = conv2d_shard(xs, w, **kwargs)
        calls["conv2d_shard"].append((xs, w, kwargs, out))
        return out

    def rec_mm(xs, w):
        out = matmul_tiled(xs, w)
        calls["matmul_tiled"].append((xs, w, out))
        return out
    return rec_conv, rec_mm


def holding_recorders(held, errs, shapes):
    """Stand-ins for the engine's conv2d_shard and matmul_tiled that call
    the wrappers and hold each eager call at once against its plain
    version on the same inputs (scale-normalised TOL): a captured
    segment program reuses its input buffers, so a call cannot be held
    after the run.  A call made while a CUDA graph captures is not held
    (nothing has run yet); its program's first, eager call was, at the
    same shapes.  Counts go to ``held``, the largest absolute differences
    to ``errs``, the call shapes to ``shapes``."""
    import torch
    from repro_torch.kernels.conv2d import conv2d_shard
    from repro_torch.kernels.ops import matmul_tiled
    from repro_torch.kernels.ref import conv2d_shard_ref, matmul_ref

    def capturing(t):
        return t.is_cuda and torch.cuda.is_current_stream_capturing()

    def hold(kname, out, plain, shape):
        e = rel_err(out, plain)
        check(e < TOL, f"{kname} call {held[kname]} {shape}: error {e:.3e}"
              f" of scale against plain")
        held[kname] += 1
        errs[kname] = max(errs[kname], abs_err(out, plain))
        shapes.add(shape)

    def rec_conv(xs, w, **kwargs):
        out = conv2d_shard(xs, w, **kwargs)
        if not capturing(xs):
            hold("conv2d_shard", out, conv2d_shard_ref(xs, w, **kwargs),
                 ("conv2d_shard", tuple(xs.shape), tuple(w.shape),
                  tuple(sorted((k, str(v)) for k, v in kwargs.items()))))
        return out

    def rec_mm(xs, w):
        out = matmul_tiled(xs, w)
        if not capturing(xs):
            hold("matmul_tiled", out, matmul_ref(xs, w),
                 ("matmul_tiled", tuple(xs.shape), tuple(w.shape), ()))
        return out
    return rec_conv, rec_mm


def top_shapes(name, conv_calls, mm_calls, card):
    """Print the TOP_SHAPES recorded call shapes of each kernel that take
    the most kernel time in one run (all calls of a shape replayed as one
    CUDA graph), each with its tile plan and the library call's time."""
    import torch
    from repro_torch.kernels import gemm
    from repro_torch.kernels.conv2d import conv2d_shard
    from repro_torch.kernels.ops import matmul_tiled

    def plan(m, n, k):
        p = gemm.plan_gemm(m, n, k)
        return f"bm{p.cfg.bm} x {p.splits} splits, {p.blocks} blocks"

    groups = {"conv2d_shard": {}, "matmul_tiled": {}}
    for xs, w, kw, out in conv_calls:
        dw = kw.get("depthwise", False)
        key = (tuple(xs.shape), tuple(w.shape), kw["stride"], kw["pads"], dw)
        groups["conv2d_shard"].setdefault(key, []).append((xs, w, kw, out))
    for xs, w, out in mm_calls:
        groups["matmul_tiled"].setdefault(
            (tuple(xs.shape), tuple(w.shape)), []).append((xs, w, out))
    for kname, by_shape in groups.items():
        timed = []
        for key, cs in by_shape.items():
            if kname == "conv2d_shard":
                ms = graph_ms(lambda: [conv2d_shard(a, b, **c)
                                       for a, b, c, _ in cs], reps=5)
                lib = graph_ms(lambda: [
                    library_conv(a, b, c["pads"], c["stride"],
                                 c.get("depthwise", False))
                    for a, b, c, _ in cs], reps=5)
                (hl, wl, cin), (k, _, _, cout), s, pads, dw = key
                ho, wo, co = cs[0][3].shape
                desc = (f"{'dw' if dw else 'dense'} [{hl},{wl},{cin}] "
                        f"k{k} s{s} pads {pads} -> [{ho},{wo},{co}]")
                if not dw:
                    desc += f" ({plan(ho * wo, co, k * k * cin)})"
            else:
                ms = graph_ms(lambda: [matmul_tiled(a, b)
                                       for a, b, _ in cs], reps=5)
                lib = graph_ms(lambda: [torch.matmul(a, b)
                                        for a, b, _ in cs], reps=5)
                (m, k), (_, n) = key
                desc = f"[{m},{k}] @ [{k},{n}] ({plan(m, n, k)})"
            timed.append((ms, lib, len(cs), desc))
        timed.sort(reverse=True)
        for ms, lib, cnt, desc in timed[:TOP_SHAPES]:
            print(f"phase 4: {name}: top {kname} shape: {desc}: {cnt} "
                  f"calls {ms:.4f} ms ({ms / cnt * 1e3:.1f} us a call; "
                  f"library {lib:.4f}) [{card}]", flush=True)


# ---------------------------------------------------------------------------
# The CNN/bert main path in bf16
# ---------------------------------------------------------------------------

def half_recorders(calls, stats):
    """Stand-ins for the engine's conv2d_shard and matmul_tiled that call
    the wrappers (so launches count as before), hold each call made
    outside a capture at once against its plain version at one ulp
    (:func:`hold_ulp`, counted in ``stats``) and record its inputs and
    output in ``calls``."""
    import torch
    from repro_torch.kernels.conv2d import conv2d_shard
    from repro_torch.kernels.ops import matmul_tiled
    from repro_torch.kernels.ref import conv2d_shard_ref, matmul_ref

    def capturing(t):
        return t.is_cuda and torch.cuda.is_current_stream_capturing()

    def rec_conv(xs, w, **kwargs):
        out = conv2d_shard(xs, w, **kwargs)
        if not capturing(xs):
            hold_ulp(f"conv2d_shard {tuple(xs.shape)} {tuple(w.shape)} "
                     f"{kwargs}", out, conv2d_shard_ref(xs, w, **kwargs),
                     conv_mag(xs, w, kwargs), stats["conv2d_shard"])
            calls["conv2d_shard"].append((xs, w, kwargs, out))
        return out

    def rec_mm(xs, w):
        out = matmul_tiled(xs, w)
        if not capturing(xs):
            hold_ulp(f"matmul_tiled {tuple(xs.shape)} {tuple(w.shape)}",
                     out, matmul_ref(xs, w),
                     xs.float().abs() @ w.float().abs(),
                     stats["matmul_tiled"])
            calls["matmul_tiled"].append((xs, w, out))
        return out
    return rec_conv, rec_mm


def phase_main_path_bf16(dev, row, ulp, card):
    """Phase 3's model, plan and seeds with the weights and input cast to
    bf16 on ``Session(..., ExecConfig(backend="cuda"))``: the eager
    records, then the segment programs' eager, capturing and replaying
    runs, bit-equal to each other, launches equal to ``kernel_records``,
    ``ExecStats`` equal to the f32 run's, every call made outside a
    capture within one ulp of its plain version; the output within
    BF16_TOL of scale of phase 3's f32 output, of ``run_reference`` in
    bf16 and of ``backend="torch"`` in bf16.  Then the mesh executor,
    overlap on and off: bit-equal across eager, capture and replay,
    within BF16_TOL of the local bf16 output, launches equal to
    ``mesh_kernel_records``, ``ExecStats`` equal, no fault.  Then the warm
    replayed run in bf16 and in f32 in turns with the card's idle share,
    and each kernel's bf16 calls of one pass (graph replay) beside plain,
    library and bound.  Returns the timing row."""
    import torch
    from repro_torch import ExecConfig, Session, run_reference
    from repro_torch.kernels.conv2d import conv2d_shard
    from repro_torch.kernels.ops import matmul_tiled
    from repro_torch.kernels import gemm
    from repro_torch.kernels.ref import conv2d_shard_ref, matmul_ref
    from repro_torch.runtime import engine, mesh_exec

    name = row["model"]
    g, ws, x, plan, out32, st32, _, _ = row["mesh_inputs"]
    t0 = time.perf_counter()
    bf = torch.bfloat16
    ws16 = [None if w is None else w.to(bf) for w in ws]
    x16 = x.to(bf)
    want = kernel_records(g, plan, NODES)
    want_counts = {"conv2d_shard": want[0], "matmul_tiled": want[1]}
    stats = {k: ulp.setdefault((k, "bfloat16", "main path"),
                               new_ulp_stats())
             for k in ("conv2d_shard", "matmul_tiled")}
    calls = {"conv2d_shard": [], "matmul_tiled": []}
    wrappers = engine.conv2d_shard, engine.matmul_tiled
    sess_e = Session(g, ws16, plan, NODES,
                     ExecConfig(backend="cuda", jit_segments=False))
    sess_k = Session(g, ws16, plan, NODES, ExecConfig(backend="cuda"))
    engine.clear_segment_cache()
    engine.conv2d_shard, engine.matmul_tiled = half_recorders(calls, stats)
    try:
        zero_counts()
        out_e, st_e = sess_e.run(x16)
        torch.cuda.synchronize()
        check_counts(f"{name} bf16 (eager records)", read_counts(),
                     want_counts)
        # every dense and FC call of the bf16 pass on the tensor cores
        want_routes = half_routes(calls["conv2d_shard"],
                                  calls["matmul_tiled"])
        check_routes(f"{name} bf16 (eager records)", read_routes(),
                     want_routes)
        timed = {k: list(v) for k, v in calls.items()}
        for run in ("eager", "capture", "replay"):
            zero_counts()
            out_k, st_k = sess_k.run(x16)
            torch.cuda.synchronize()
            check_counts(f"{name} bf16 ({run} run)", read_counts(),
                         want_counts)
            check_routes(f"{name} bf16 ({run} run)", read_routes(),
                         want_routes)
            counts = read_counts()
            check(torch.equal(out_k, out_e),
                  f"{name} bf16: {run} run of the segment programs differs "
                  f"from jit_segments=False by {abs_err(out_k, out_e)}")
            check(st_k == st_e, f"{name} bf16: {run} run ExecStats {st_k} "
                                f"!= {st_e}")
    finally:
        engine.conv2d_shard, engine.matmul_tiled = wrappers
    out_t, st_t = Session(g, ws16, plan, NODES,
                          ExecConfig(backend="torch")).run(x16)
    ref16 = run_reference(g, ws16, x16)
    torch.cuda.synchronize()
    check(out_e.dtype == bf and tuple(out_e.shape) == tuple(out32.shape),
          f"{name} bf16: output {out_e.dtype} {tuple(out_e.shape)}")
    check(bool(torch.isfinite(out_e).all()), f"{name} bf16: non-finite")
    errs16 = {"f32 run": rel_err(out_e, out32),
              "run_reference bf16": rel_err(out_e, ref16),
              "backend=torch bf16": rel_err(out_e, out_t)}
    for what, e in errs16.items():
        check(e < BF16_TOL, f"{name} bf16: {e:.3g} of scale from the {what}")
    check(st_e == st32, f"{name} bf16: ExecStats {st_e} != the f32 run's "
                        f"{st32}")
    check(st_t == st_e, f"{name} bf16: backend=torch ExecStats {st_t}")
    print(f"phase 4b: {name} bf16: launches conv2d_shard={want[0]} "
          f"matmul_tiled={want[1]} == plan records on the eager-records, "
          f"eager, capture and replay runs, by loop "
          f"{routes_text(want_routes)} on each, the three bit-equal to the "
          f"eager records; ExecStats equal to the f32 run's; of scale, "
          + ", ".join(f"{e:.3g} from the {w}" for w, e in errs16.items())
          + f"; calls held so far: conv2d_shard "
          f"{ulp_text(stats['conv2d_shard'])}; matmul_tiled "
          f"{ulp_text(stats['matmul_tiled'])}", flush=True)

    # the mesh executor in bf16
    for overlap in (True, False):
        mwant = mesh_kernel_records(g, plan, NODES, overlap)
        mcounts = {"conv2d_shard": mwant[0], "matmul_tiled": mwant[1]}
        mesh_exec.clear_mesh_program_cache()
        sess = Session(g, ws16, plan, NODES, ExecConfig(
            backend="cuda", executor="mesh", overlap=overlap))
        outs = []
        mcalls = {"conv2d_shard": [], "matmul_tiled": []}
        for run in ("eager", "capture", "replay"):
            zero_counts()
            if run == "eager":
                engine.conv2d_shard, engine.matmul_tiled = \
                    half_recorders(mcalls, stats)
            try:
                o, st = sess.run(x16)
            finally:
                engine.conv2d_shard, engine.matmul_tiled = wrappers
            torch.cuda.synchronize()
            check_counts(f"{name} bf16 mesh overlap={overlap} ({run} run)",
                         read_counts(), mcounts)
            if run == "eager":
                mroutes = half_routes(mcalls["conv2d_shard"],
                                      mcalls["matmul_tiled"])
            check_routes(f"{name} bf16 mesh overlap={overlap} ({run} run)",
                         read_routes(), mroutes)
            check(st == st32 and st.failure_count == 0,
                  f"{name} bf16 mesh overlap={overlap}: {run} run "
                  f"ExecStats {st}, the local f32 run's {st32}")
            outs.append(o)
        check(all(torch.equal(o, outs[0]) for o in outs),
              f"{name} bf16 mesh overlap={overlap}: eager, capture and "
              f"replay runs differ")
        e = rel_err(outs[0], out_e)
        check(e < BF16_TOL, f"{name} bf16 mesh overlap={overlap}: {e:.3g} "
                            f"of scale from the local bf16 output")
        same = "bit-equal" if torch.equal(outs[0], out_e) else \
            "not bit-equal"
        print(f"phase 4b: {name} bf16 mesh overlap={overlap}: launches "
              f"{mwant} == mesh_kernel_records on the eager, capture and "
              f"replay runs, by loop {routes_text(mroutes)}, the three "
              f"bit-equal, {e:.3g} of scale from "
              f"the local bf16 output ({same}), ExecStats equal, "
              f"failure_count 0; the eager run's "
              f"{len(mcalls['conv2d_shard'])} + "
              f"{len(mcalls['matmul_tiled'])} calls held at one ulp",
              flush=True)
        del mcalls, sess
        mesh_exec.clear_mesh_program_cache()

    # warm walls: the replayed programs in bf16 and in f32, in turns
    sess32 = Session(g, ws, plan, NODES, ExecConfig(backend="cuda"))
    for _ in range(2):
        sess32.run(x)
    walls = walls_in_turns({"bf16": lambda: sess_k.run(x16),
                            "f32": lambda: sess32.run(x)}, SESSION_REPS)
    prof = {"bf16": device_profile(lambda: sess_k.run(x16), 3),
            "f32": device_profile(lambda: sess32.run(x), 3)}
    out = {"model": name, "bf16_ms": spread(walls["bf16"]),
           "f32_ms": spread(walls["f32"]), "launches": counts,
           "routes": want_routes}
    (bm_, blo, bhi), (fm, flo, fhi) = out["bf16_ms"], out["f32_ms"]
    print(f"phase 4b: {name}: warm replayed Session.run bf16 {bm_:.3f} ms "
          f"(range {blo:.3f}-{bhi:.3f}), f32 {fm:.3f} ms (range "
          f"{flo:.3f}-{fhi:.3f}); medians of {SESSION_REPS} synchronised "
          f"runs each, in turns; profiled: bf16 "
          f"{profile_text(*prof['bf16'][:3], bm_)}; f32 "
          f"{profile_text(*prof['f32'][:3], fm)} [{card}]", flush=True)
    engine.clear_segment_cache()

    # the bf16 calls of one pass: kernel, plain, library, bound
    conv_calls, mm_calls = timed["conv2d_shard"], timed["matmul_tiled"]
    if conv_calls:
        nbytes = flops = 0.0
        for xs, w, kw, o in conv_calls:
            b, f = conv_work(xs, w, o, kw.get("depthwise", False))
            nbytes += b
            flops += f
        out["conv2d_shard"] = dict(
            calls=len(conv_calls), bytes=nbytes, flops=flops,
            ms=graph_ms(lambda: [conv2d_shard(a, b, **c)
                                 for a, b, c, _ in conv_calls]),
            plain_ms=graph_ms(lambda: [conv2d_shard_ref(a, b, **c)
                                       for a, b, c, _ in conv_calls]),
            library_ms=graph_ms(lambda: [
                library_conv(a, b, c["pads"], c["stride"],
                             c.get("depthwise", False))
                for a, b, c, _ in conv_calls]))
    if mm_calls:
        nbytes = flops = 0.0
        for xs, w, o in mm_calls:
            b, f = matmul_work(xs, w, o)
            nbytes += b
            flops += f
        out["matmul_tiled"] = dict(
            calls=len(mm_calls), bytes=nbytes, flops=flops,
            ms=graph_ms(lambda: [matmul_tiled(a, b)
                                 for a, b, _ in mm_calls]),
            plain_ms=graph_ms(lambda: [matmul_ref(a, b)
                                       for a, b, _ in mm_calls]),
            library_ms=graph_ms(lambda: [torch.matmul(a, b)
                                         for a, b, _ in mm_calls]))
        # each FC shape of the pass: the kernel against cuBLAS in bf16
        by_shape = {}
        for xs, w, _ in mm_calls:
            by_shape.setdefault((xs.shape[0], xs.shape[1], w.shape[1]),
                                []).append((xs, w))
        out["matmul_tiled"]["shapes"] = shapes = []
        for (m, k, n), cs in sorted(by_shape.items(),
                                    key=lambda kv: -len(kv[1])):
            plan = gemm.plan_gemm(m, n, k, True)
            shapes.append(dict(
                model=name, shape=f"[{m},{k}]@[{k},{n}]", calls=len(cs),
                cfg=plan.cfg.index, splits=plan.splits,
                ms=graph_ms(lambda: [matmul_tiled(a, b) for a, b in cs]),
                library_ms=graph_ms(lambda: [torch.matmul(a, b)
                                             for a, b in cs])))
            r = shapes[-1]
            print(f"phase 4b: {name} bf16 matmul_tiled [{m},{k}] @ "
                  f"[{k},{n}] (cfg {r['cfg']} x {r['splits']} splits): "
                  f"{len(cs)} calls {r['ms']:.4f} ms "
                  f"({r['ms'] / len(cs) * 1e3:.2f} us a call), cuBLAS "
                  f"{r['library_ms']:.4f} ms "
                  f"({r['library_ms'] / len(cs) * 1e3:.2f} us a call), "
                  f"kernel / cuBLAS {r['ms'] / r['library_ms']:.2f}x "
                  f"[{card}]", flush=True)
    parts = []
    for kname in ("conv2d_shard", "matmul_tiled"):
        r = out.get(kname)
        if r:
            bm, by = bound_ms(r["bytes"], r["flops"], PEAK_BF16_FLOPS)
            f32 = row.get(kname, {})
            parts.append(
                f"{kname}: {r['calls']} calls, {r['ms']:.4f} ms (f32 "
                f"{f32.get('ms', float('nan')):.4f}; plain "
                f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, "
                f"bound {bm:.4f} by {by}; {r['flops'] / 1e9:.3f} GFLOP, "
                f"{r['bytes'] / 1e6:.2f} MB)")
    del timed, calls, conv_calls, mm_calls
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 4b: {name} bf16 kernels a pass (graph replay): "
          + "; ".join(parts) + f"; the model's phase took "
          f"{out['seconds']:.1f} s [{card}]", flush=True)
    return out


# ---------------------------------------------------------------------------
# Decode and attention
# ---------------------------------------------------------------------------

def paged_pools(gen, dev, lh, hd, ps, n_pages, kv_len, window):
    """Random pools behind a scrambled table: the kernel's copy holds NaN
    in every page it must not read (past ceil(kv_len/ps), before the
    window's page), the plain version's copy zeros there."""
    import torch
    from repro_torch.kernels.ref import live_pages
    kp = torch.randn((lh, n_pages, ps, hd), generator=gen, device=dev)
    vp = torch.randn((lh, n_pages, ps, hd), generator=gen, device=dev)
    table = torch.randperm(n_pages, generator=gen, device=dev).int()
    lo, hi = live_pages(kv_len, ps, window)
    dead = table[torch.cat([torch.arange(lo), torch.arange(hi, n_pages)])
                 .to(dev)].long()
    kz, vz = kp.clone(), vp.clone()
    kz[:, dead] = 0.0
    vz[:, dead] = 0.0
    kp[:, dead] = float("nan")
    vp[:, dead] = float("nan")
    return kp, vp, kz, vz, table


def phase_decode_grid(dev, errs):
    """flash_decode_paged against its plain version: 4 and 16 heads, hd 64
    and 128, page sizes 1 and 16 over 256 physical pages, kv_len up to the
    capacity (4096 keys at ps 16), no window and windows whose first key
    lands mid-page, scrambled table, NaN in every page it must not read;
    each case again with kv_len read from a device int32 (the decode
    step's path), bit-equal to the by-value call."""
    import torch
    from repro_torch.kernels.flash_attention import flash_decode_paged
    from repro_torch.kernels.ref import flash_decode_paged_ref

    gen = torch.Generator(device=dev).manual_seed(12)
    length = torch.zeros((1,), dtype=torch.int32, device=dev)
    n_pages, n = 256, 0
    r0 = decode_routes()
    for lh in (4, 16):
        for hd in (64, 128):
            for ps in (1, 16):
                cap = n_pages * ps
                for kv_len in sorted({1, 15, 16, 17, cap * 25 // 32, cap}):
                    q = torch.randn((lh, hd), generator=gen, device=dev)
                    for window in (None, 7, 100, 1000):
                        kp, vp, kz, vz, table = paged_pools(
                            gen, dev, lh, hd, ps, n_pages, kv_len, window)
                        out = flash_decode_paged(q, kp, vp, table, kv_len,
                                                 window=window)
                        length.fill_(kv_len)
                        by_ptr = flash_decode_paged(q, kp, vp, table,
                                                    length, window=window)
                        ref = flash_decode_paged_ref(q, kz, vz, table,
                                                     kv_len, window=window)
                        torch.cuda.synchronize()
                        check(torch.equal(out, by_ptr),
                              f"flash_decode_paged lh{lh} hd{hd} ps{ps} "
                              f"kv{kv_len} w{window}: device kv_len differs "
                              f"by {abs_err(by_ptr, out)}")
                        check(bool(torch.isfinite(out).all()),
                              f"flash_decode_paged lh{lh} hd{hd} ps{ps} "
                              f"kv{kv_len} w{window}: read a dead page")
                        e = rel_err(out, ref)
                        check(e < DECODE_TOL,
                              f"flash_decode_paged lh{lh} hd{hd} ps{ps} "
                              f"kv{kv_len} w{window}: error {e}")
                        errs["flash_decode_paged"] = max(
                            errs["flash_decode_paged"], abs_err(out, ref))
                        n += 1
    check_decode_routes("phase 5", r0, 2 * n, 0)
    print(f"phase 5: flash_decode_paged == plain on {n} cases (heads 4/16 "
          f"x hd 64/128 x ps 1/16 x 6 lengths x 4 windows, NaN in unread "
          f"pages); max abs err {errs['flash_decode_paged']:.3g}; kv_len "
          f"from device memory bit-equal to by value in all {n}; all "
          f"{2 * n} calls on the per-row route", flush=True)


def decode_launch_shape(kp, vp, n_logical, groups=1) -> dict:
    """The launch of a paged decode call on pools ``kp``/``vp`` behind a
    table of ``n_logical`` pages, ``groups`` query rows a pool row, as
    ``flash_attention.decode_shape`` chooses it: splits (the cluster
    size), warps a block, query rows a block (1: the per-row route),
    blocks, the clusters the card holds at once and the waves the grid
    takes."""
    import ctypes
    import importlib
    import torch
    from repro_torch.kernels import build
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    rows, _, ps, hd = kp.shape
    shape = fa.decode_shape(rows, groups, n_logical, ps)
    qblocks = rows * -(-groups // shape.group_rows)
    info = (ctypes.c_int * 4)()
    lib = build.load("flash_decode_paged")
    fn = (lib.flash_decode_paged_occupancy if kp.dtype == torch.float32
          else lib.flash_decode_paged_occupancy_bf16)
    rc = fn(rows * groups, hd, int(fa.decode_vec(hd, kp, vp)), shape.splits,
            shape.warps, groups, shape.group_rows, n_logical, ps, info)
    check(rc == 0, f"flash_decode_paged_occupancy failed: cudaError {rc}")
    threads, smem, clusters, per_round = info
    return dict(splits=shape.splits, warps=shape.warps,
                group_rows=shape.group_rows, blocks=qblocks * shape.splits,
                clusters=clusters, waves=qblocks / clusters,
                rows_a_round=per_round, smem_bytes=smem)


def shape_text(shape) -> str:
    rows = "one query row" if shape["group_rows"] == 1 else \
        f"{shape['group_rows']} query rows"
    return (f"{shape['blocks']} blocks of {shape['warps']} warps, "
            f"{rows} each, in clusters of {shape['splits']} "
            f"({shape['clusters']} clusters resident, {shape['waves']:.2f} "
            f"waves; {shape['rows_a_round']} keys a block a round; "
            f"{shape['smem_bytes']} shared bytes)")


def phase_decode_long(dev, errs, card):
    """flash_decode_paged at long context (``LONG_DECODE``), where bytes set
    the pace: each case rotates through enough pool copies that a pass
    reads more than the L2 holds; times against the bytes bound, the plain
    version and gather + SDPA; returns one row per case."""
    import torch
    from repro_torch.kernels.flash_attention import flash_decode_paged
    from repro_torch.kernels.ref import flash_decode_paged_ref

    gen = torch.Generator(device=dev).manual_seed(13)
    rows = []
    for lh, hd, ps, kv_len in LONG_DECODE:
        n_pages = kv_len // ps
        pair = 2 * lh * n_pages * ps * hd * 4
        copies = max(2, -(-LONG_DECODE_BYTES // pair))
        q = torch.randn((lh, hd), generator=gen, device=dev)
        table = torch.randperm(n_pages, generator=gen, device=dev).int()
        pools = [(torch.randn((lh, n_pages, ps, hd), generator=gen,
                              device=dev),
                  torch.randn((lh, n_pages, ps, hd), generator=gen,
                              device=dev)) for _ in range(copies)]
        kp, vp = pools[0]
        out = flash_decode_paged(q, kp, vp, table, kv_len)
        plain = flash_decode_paged_ref(q, kp, vp, table, kv_len)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()),
              f"long decode lh{lh}: non-finite output")
        e = rel_err(out, plain)
        check(e < DECODE_TOL, f"long decode lh{lh}: error {e}")
        errs["flash_decode_paged"] = max(errs["flash_decode_paged"],
                                         abs_err(out, plain))
        nbytes, _ = decode_work(q, kp, kv_len, None)
        bound = nbytes / PEAK_BYTES * 1e3
        sc = 1.0 / hd ** 0.5
        row = dict(
            heads=lh, hd=hd, ps=ps, kv_len=kv_len, bytes=nbytes,
            bound_ms=bound,
            ms=graph_ms(lambda: [flash_decode_paged(q, a, b, table, kv_len)
                                 for a, b in pools]) / copies,
            plain_ms=graph_ms(lambda: [flash_decode_paged_ref(
                q, a, b, table, kv_len) for a, b in pools], reps=5)
            / copies,
            library_ms=graph_ms(lambda: [library_decode(q, a, b, table,
                                                        kv_len, sc)
                                         for a, b in pools], reps=5)
            / copies,
            **decode_launch_shape(kp, vp, n_pages))
        rows.append(row)
        print(f"phase 5: long decode {lh} heads hd {hd} ps {ps} kv_len "
              f"{kv_len} ({nbytes / 1e6:.2f} MB of live K/V, {copies} pool "
              f"copies rotated): err {e:.3g}; flash_decode_paged "
              f"{row['ms'] * 1e3:.2f} us, {bound / row['ms'] * 100:.1f}% of "
              f"its bytes bound {bound * 1e3:.2f} us (plain "
              f"{row['plain_ms'] * 1e3:.2f} us, gather + sdpa "
              f"{row['library_ms'] * 1e3:.2f} us); {shape_text(row)} "
              f"[{card}]", flush=True)
        del pools, kp, vp
    return rows


def decode_launches(spec, plan, nodes, n_steps) -> int:
    """flash_decode_paged launches of ``n_steps`` decode steps of ``plan``,
    from the plan alone: per step and layer, one per node that owns heads
    (OutC ATTN) or one (replicated)."""
    from repro_torch.core.partition import Scheme, split_sizes
    per_step = 0
    for i in range(spec.n_layers):
        if plan.steps[2 * i][0] == Scheme.OUTC:
            per_step += sum(1 for h in split_sizes(spec.n_heads, nodes) if h)
        else:
            per_step += 1
    return per_step * n_steps


def library_decode(q, kp, vp, table, kv_len, scale):
    """One library call for the paged decode: gather the live pages by
    table, cut to the live keys, then F.scaled_dot_product_attention."""
    import torch.nn.functional as F
    from repro_torch.kernels.ref import live_pages
    lh, _, ps, hd = kp.shape
    lo, hi = live_pages(kv_len, ps)
    phys = table[lo:hi].long()
    k = kp[:, phys].reshape(lh, -1, hd)[:, :kv_len - lo * ps]
    v = vp[:, phys].reshape(lh, -1, hd)[:, :kv_len - lo * ps]
    return F.scaled_dot_product_attention(q[:, None], k, v, scale=scale)[:, 0]


def decode_work(q, kp, kv_len, window):
    """(bytes, flops) one paged decode call must move and do: the live K
    and V rows, q, out and the live table entries."""
    from repro_torch.kernels.ref import live_pages
    lh, _, ps, hd = kp.shape
    lo, hi = live_pages(kv_len, ps, window)
    first = 0 if window is None else max(0, kv_len - window)
    rows = kv_len - first
    return (4.0 * (2 * lh * rows * hd + 2 * lh * hd + (hi - lo)),
            4.0 * lh * rows * hd)


def phase_decode_path(dev, errs, card):
    """plan_decode -> greedy_decode(DecodeSession(backend="cuda")) at
    OLMo-1B's widths and depth, the step a captured CUDA graph (eager on
    the first step, captured on the second, replayed after), against the
    eager step body; returns the decode kernel's timing row."""
    import numpy as np
    import torch
    from repro_torch import (DecodeSession, ExecConfig, TransformerSpec,
                             greedy_decode, init_transformer, plan_decode,
                             reference_decode)
    from repro_torch import Testbed as TorchTestbed
    from repro_torch.kernels.flash_attention import flash_decode_paged
    from repro_torch.kernels.ref import flash_decode_paged_ref
    from repro_torch.runtime import decode as decode_mod
    from repro_torch.runtime.graphs import GraphProgram

    spec = TransformerSpec(**OLMO)
    tb = TorchTestbed(nodes=NODES, bandwidth_gbps=5.0, link_latency_us=1.0)
    t0 = time.perf_counter()
    res = plan_decode(spec, 2048, NODES, tb=tb)
    plan_s = time.perf_counter() - t0
    plan = res.plan
    n_steps = PROMPT_LEN + N_NEW
    want = decode_launches(spec, plan, NODES, n_steps)
    t0 = time.perf_counter()
    w = init_transformer(spec, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = w["emb"].numel() + sum(a.numel() for blk in w["blocks"]
                                      for a in blk.values())
    prompt = [int(t) for t in np.random.default_rng(1).integers(
        0, spec.vocab, PROMPT_LEN)]
    kw = dict(page_size=PAGE_SIZE, capacity=CAPACITY)

    def session(backend, graphed=True):
        sess = DecodeSession(spec, w, plan, NODES,
                             ExecConfig(backend=backend), **kw)
        check(isinstance(sess._step_fn, GraphProgram),
              "decode: the step on the card is not a GraphProgram")
        if not graphed:
            sess._step_fn = sess._local_step   # the eager step body
        return sess

    sess_k = session("cuda")
    zero_counts()
    t0 = time.perf_counter()
    toks_k, lg_k = greedy_decode(sess_k, prompt, N_NEW)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = read_counts()
    check_counts("decode", counts, {"flash_decode_paged": want})
    check_decode_routes("decode", {}, want, 0)
    check(sess_k._step_fn.graph is not None
          and sess_k._step_fn.calls == n_steps,
          "decode: the step was not captured and replayed")

    sess_e = session("cuda", graphed=False)
    t0 = time.perf_counter()
    toks_e, lg_e = greedy_decode(sess_e, prompt, N_NEW)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    toks_t, lg_t = greedy_decode(session("torch"), prompt, N_NEW)
    toks_r, lg_r = reference_decode(spec, w, prompt, N_NEW)
    torch.cuda.synchronize()
    same_bits = torch.equal(lg_k, lg_e)
    e_e = abs_err(lg_k, lg_e)
    check(tuple(lg_k.shape) == (N_NEW, spec.vocab),
          f"decode: logits shape {tuple(lg_k.shape)}")
    check(bool(torch.isfinite(lg_k).all()), "decode: non-finite logits")
    top2 = lg_k.topk(2, dim=-1).values
    margin = float((top2[:, 0] - top2[:, 1]).min())
    e_r, e_t = rel_err(lg_k, lg_r), rel_err(lg_k, lg_t)
    print(f"phase 6: decode olmo-1b widths ({spec.n_layers} layers, d "
          f"{spec.d_model}, {spec.n_heads} heads, d_ff {spec.d_ff}, vocab "
          f"{spec.vocab}; {n_params / 1e9:.3f} B params, init "
          f"{init_s:.1f} s): plan {sorted({s.name for s, _ in plan.steps})}"
          f" at {NODES} nodes (searched in {plan_s:.3f} s), heads per node "
          f"{sess_k.head_split[0]}; prompt {PROMPT_LEN} + {N_NEW} new "
          f"tokens in {run_s:.2f} s through the captured step ({eager_s:.2f}"
          f" s through the eager body); launches flash_decode_paged="
          f"{counts['flash_decode_paged']} == plan {want}; logits vs "
          f"reference_decode {e_r:.3g}, vs torch backend {e_t:.3g} (scale-"
          f"normalised); captured vs eager body: tokens "
          f"{'identical' if toks_k == toks_e else 'DIFFER'}, logits "
          f"{'bit-equal' if same_bits else f'differ by {e_e:.3g}'}; "
          f"smallest top-two logit margin {margin:.4g}", flush=True)
    check(toks_k == toks_r, f"decode: tokens {toks_k} != reference_decode "
                            f"{toks_r} (smallest margin {margin})")
    check(toks_k == toks_t, f"decode: tokens {toks_k} != torch backend "
                            f"{toks_t}")
    check(toks_k == toks_e, f"decode: tokens {toks_k} != eager body "
                            f"{toks_e}")
    check(e_r < TOL, f"decode: logits vs reference_decode {e_r}")
    check(e_t < TOL, f"decode: logits vs torch backend {e_t}")
    check(rel_err(lg_k, lg_e) < TOL, f"decode: logits vs eager body {e_e}")
    del sess_k, sess_e

    # warm per-token step: fresh sessions past the same prompt, the eager
    # body and the replayed graph
    emb = w["emb"]
    step_ms = {}
    for label, graphed in (("eager", False), ("graph", True)):
        sess = session("cuda", graphed)
        h = sess.prefill(prompt)
        tok = int(torch.argmax(h @ emb.T))
        steps = []
        for _ in range(N_NEW):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = sess.step(tok)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
            tok = int(torch.argmax(h @ emb.T))
        step_ms[label] = spread(steps)
        if graphed:
            # the device's own time for a step: back-to-back replays of
            # the captured step (each rewrites the last position's K/V)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(N_NEW):
                sess._step_fn.graph.replay()
            end.record()
            torch.cuda.synchronize()
            step_ms["device"] = start.elapsed_time(end) / N_NEW
            step_prof = device_profile(sess._step_fn.graph.replay, 8)
        del sess

    # record the kernel calls of one run of the eager body (a replayed
    # graph calls no wrapper), each with a copy of its device kv_len
    calls = []

    def rec(q, kp, vp, table, kv_len, **kwargs):
        out = flash_decode_paged(q, kp, vp, table, kv_len, **kwargs)
        calls.append((q, kp, vp, table, kv_len.clone(), kwargs, out))
        return out

    decode_mod.flash_decode_paged = rec
    r0 = decode_routes()
    try:
        greedy_decode(session("cuda", graphed=False), prompt, N_NEW)
    finally:
        decode_mod.flash_decode_paged = flash_decode_paged
    check(len(calls) == want, f"decode: recorded {len(calls)} calls")
    check_decode_routes("decode (eager body)", r0, want, 0)
    lengths = torch.cat([c[4] for c in calls]).tolist()
    check(lengths == [t + 1 for t in range(n_steps) for _ in
                      range(want // n_steps)],
          "decode: recorded kv_len is not the position + 1")
    # (q, kp, vp, table, device kv_len, int kv_len, kwargs, out)
    calls = [c[:5] + (n,) + c[5:] for c, n in zip(calls, lengths)]
    diff = torch.zeros((), device=dev)
    scale = torch.ones((), device=dev)
    nbytes = flops = 0.0
    for q, kp, vp, table, _, kv_len, kwargs, out in calls:
        plain = flash_decode_paged_ref(q, kp, vp, table, kv_len, **kwargs)
        diff = torch.maximum(diff, (out - plain).abs().max())
        scale = torch.maximum(scale, plain.abs().max())
        b, f = decode_work(q, kp, kv_len, kwargs.get("window"))
        nbytes += b
        flops += f
    e = float(diff) / float(scale)
    check(e < DECODE_TOL, f"decode: recorded calls vs plain {e}")
    errs["flash_decode_paged"] = max(errs["flash_decode_paged"],
                                     float(diff))
    sc = 1.0 / spec.head_dim ** 0.5
    row = dict(
        calls=len(calls), bytes=nbytes, flops=flops, step_ms=step_ms,
        run_s=run_s, margin=margin, launches=counts["flash_decode_paged"],
        mesh_inputs=(spec, w, plan, prompt, toks_k, lg_k, toks_r, lg_r),
        ms=graph_ms(lambda: [flash_decode_paged(q, a, b, t, d, **k)
                             for q, a, b, t, d, _, k, _ in calls],
                    reps=DECODE_REPS),
        plain_ms=graph_ms(lambda: [flash_decode_paged_ref(q, a, b, t, n, **k)
                                   for q, a, b, t, _, n, k, _ in calls],
                          reps=DECODE_REPS),
        library_ms=graph_ms(lambda: [library_decode(q, a, b, t, n, sc)
                                     for q, a, b, t, _, n, _, _ in calls],
                            reps=DECODE_REPS))
    bm, by = bound_ms(nbytes, flops)
    _, kp0, vp0, table0 = calls[0][:4]
    shape = decode_launch_shape(kp0, vp0, len(table0))
    check(all(c[1].shape == kp0.shape and len(c[3]) == len(table0)
              for c in calls), "decode: recorded calls of several shapes")
    (em, elo, ehi), (gm, glo, ghi) = step_ms["eager"], step_ms["graph"]
    dm = step_ms["device"]
    n_kernels, prof_ms, busy_ms, by_name = step_prof
    groups = {"cuBLAS products": 0.0, "flash_decode_paged": 0.0,
              "other": 0.0}
    for kname, ms in by_name.items():
        group = ("cuBLAS products" if "gemv" in kname or "gemm" in kname
                 else "flash_decode_paged" if "decode_kernel" in kname
                 else "other")
        groups[group] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"phase 7: the replayed step's kernels (torch.profiler over 8 "
          f"replays): {profile_text(n_kernels, prof_ms, busy_ms, gm)}; by "
          f"group "
          + ", ".join(f"{g} {ms:.3f} ms" for g, ms in groups.items())
          + "; the costliest: " + "; ".join(
              f"{kname[:60]} {ms:.3f} ms" for kname, ms in top)
          + f" [{card}]", flush=True)
    print(f"phase 7: decode warm step: eager body {em:.3f} ms per token "
          f"(range {elo:.3f}-{ehi:.3f}), replayed graph {gm:.3f} ms (range "
          f"{glo:.3f}-{ghi:.3f}); medians of {N_NEW} synchronised steps; "
          f"the captured step's device time {dm:.3f} ms ({N_NEW} "
          f"back-to-back replays between CUDA events), so the device is "
          f"idle {max(0.0, 1 - dm / gm) * 100:.1f}% of a synchronised "
          f"step; "
          f"flash_decode_paged: {len(calls)} calls of one run with kv_len "
          f"from device memory, "
          f"{row['ms']:.3f} ms (plain {row['plain_ms']:.3f}, library "
          f"{row['library_ms']:.3f}, bound {bm:.4f} by {by}; "
          f"{nbytes / 1e9:.3f} GB live K/V); a call "
          f"{row['ms'] / len(calls) * 1e3:.3f} us on pools "
          f"{list(kp0.shape)} behind a {len(table0)}-page table: "
          f"{shape_text(shape)} [{card}]", flush=True)
    return row


def attention_pairs(S, causal, window) -> int:
    """(query, key) pairs the masks keep in one [S, S] head."""
    import numpy as np
    qi = np.arange(S, dtype=np.int64)
    hi = qi + 1 if causal else np.full(S, S, np.int64)
    lo = np.maximum(0, qi - window + 1) if window is not None else 0
    return int((hi - lo).sum())


def plain_attention(q, k, v, causal, window, lse=False):
    """The plain version one head at a time (the [S, S] scores of one head
    at a time fit in memory), query head h reading kv head h // (H / KV);
    with ``lse`` also the plain log-sum-exp [B, H, S]."""
    import torch
    from repro_torch.kernels.ref import flash_attention_ref
    rep = q.shape[1] // k.shape[1]
    outs = []
    for h in range(q.shape[1]):
        g = h // rep
        outs.append(flash_attention_ref(q[:, h:h + 1], k[:, g:g + 1],
                                        v[:, g:g + 1], causal=causal,
                                        window=window, return_lse=lse))
    if lse:
        return (torch.cat([o for o, _ in outs], dim=1),
                torch.cat([x for _, x in outs], dim=1))
    return torch.cat(outs, dim=1)


def sdpa_backend(call) -> str:
    """The backend that ``F.scaled_dot_product_attention`` dispatches
    ``call`` to: the first backend in PyTorch's priority order that is
    enabled and takes the call when ``sdpa_kernel`` allows it alone."""
    import warnings
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    enabled = {
        SDPBackend.FLASH_ATTENTION: torch.backends.cuda.flash_sdp_enabled(),
        SDPBackend.EFFICIENT_ATTENTION:
            torch.backends.cuda.mem_efficient_sdp_enabled(),
        SDPBackend.CUDNN_ATTENTION: torch.backends.cuda.cudnn_sdp_enabled(),
        SDPBackend.MATH: torch.backends.cuda.math_sdp_enabled(),
    }
    for b in torch._C._get_sdp_priority_order():
        backend = SDPBackend(b)
        if not enabled.get(backend, False):
            continue
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                with sdpa_kernel([backend]):
                    call()
                torch.cuda.synchronize()
            except RuntimeError:
                continue
        return backend.name.lower()
    return "none"


def flash_launch_shape(q, causal) -> dict:
    """The launch shape of the kernel instance that takes ``q`` [B, H, S,
    hd]: blocks, blocks an SM holds, and blocks over one wave of the
    card."""
    import ctypes
    import torch
    from repro_torch.kernels import build
    B, H, S, hd = q.shape
    info = (ctypes.c_int * 4)()
    rc = build.load("flash_attention").flash_attention_occupancy(
        int(q.dtype == torch.bfloat16), B, H, S, hd, int(causal), info)
    check(rc == 0, f"flash_attention_occupancy failed: cudaError {rc}")
    bq, bk, smem, per_sm = info
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    blocks = -(-S // bq) * B * H
    return dict(blocks=blocks, per_sm=per_sm, keys_a_stage=bk,
                smem_bytes=smem, waves=blocks / (per_sm * sms), sms=sms)


def phase_flash(dev, errs, card):
    """ops.flash_attention at full width; returns one timing row per
    case."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(21)
    inputs = []
    for case in FLASH_CASES:
        _, B, H, KV, S, hd, causal, window, dt = case
        dtype = getattr(torch, dt)
        q = torch.randn((B, H, S, hd), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, KV, S, hd), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, KV, S, hd), generator=gen, device=dev).to(dtype)
        inputs.append((case, q, k, v))
    zero_counts()
    outs = [ops.flash_attention(q, k, v, causal=c[6], window=c[7])
            for c, q, k, v in inputs]
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts("flash attention", counts,
                 {"flash_attention_bh": len(FLASH_CASES)})
    rows = []
    for (case, q, k, v), out in zip(inputs, outs):
        name, B, H, KV, S, hd, causal, window, dt = case
        f32 = dt == "float32"
        plain = plain_attention(q, k, v, causal, window)
        torch.cuda.synchronize()
        check(out.dtype == q.dtype and out.shape == q.shape,
              f"{name}: output {out.dtype} {tuple(out.shape)}")
        again = ops.flash_attention(q, k, v, causal=causal, window=window)
        check(torch.equal(out, again),
              f"{name}: two calls on the same inputs differ")
        del again
        e = rel_err(out, plain)
        check(e < (TOL if f32 else BF16_TOL), f"{name}: error {e}")
        errs["flash_attention_bh"] = max(errs["flash_attention_bh"],
                                         abs_err(out, plain))
        nbytes = float(q.element_size() * (2 * q.numel() + 2 * k.numel()))
        flops = 4.0 * hd * attention_pairs(S, causal, window) * B * H
        peak = PEAK_3XTF32_FLOPS if f32 else PEAK_BF16_FLOPS
        t_b, t_o = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
        rep = H // KV
        ke, ve = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
        mask = None
        if window is not None:
            qi = torch.arange(S, device=dev)[:, None]
            ki = torch.arange(S, device=dev)[None, :]
            mask = ki > qi - window
            if causal:
                mask &= ki <= qi
        sc = 1.0 / hd ** 0.5

        def library():
            return F.scaled_dot_product_attention(
                q, ke, ve, attn_mask=mask,
                is_causal=causal and mask is None, scale=sc)
        row = dict(
            name=name, bytes=nbytes, flops=flops,
            bound_ms=max(t_b, t_o), bound_by="bytes" if t_b >= t_o
            else "operations",
            ms=graph_ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                                    window=window), reps=5),
            plain_ms=graph_ms(lambda: plain_attention(q, k, v, causal,
                                                      window), reps=3),
            library_ms=graph_ms(library, reps=5),
            sdpa_backend=sdpa_backend(library),
            **flash_launch_shape(q, causal))
        rows.append(row)
        print(f"phase 8: {name} (B{B} H{H} KV{KV} S{S} hd{hd} "
              f"{'causal' if causal else 'non-causal'} window {window} "
              f"{dt}): err {e:.3g}, two calls bit-equal; flash_attention_bh "
              f"{row['ms']:.3f} ms, {flops / row['ms'] / 1e9:.1f} TFLOP/s "
              f"(plain {row['plain_ms']:.3f}, sdpa {row['library_ms']:.3f} "
              f"by its {row['sdpa_backend']} backend, bound "
              f"{row['bound_ms']:.4f} by {row['bound_by']} at "
              f"{peak / 1e12:.0f} TFLOP/s; {flops / 1e9:.1f} GFLOP; "
              f"{row['blocks']} blocks, {row['per_sm']} an SM, "
              f"{row['keys_a_stage']} keys a stage, {row['smem_bytes']} B "
              f"shared, {row['waves']:.2f} waves of {row['sms']} SMs) "
              f"[{card}]", flush=True)
        del ke, ve, mask, plain
    print(f"phase 8: {len(rows)} cases: flash_attention_bh "
          f"{sum(r['ms'] for r in rows):.3f} ms, sdpa "
          f"{sum(r['library_ms'] for r in rows):.3f} ms, bound "
          f"{sum(r['bound_ms'] for r in rows):.4f} ms [{card}]", flush=True)
    return rows


# ---------------------------------------------------------------------------
# The mesh executor
# ---------------------------------------------------------------------------

def stage_text(st, first=STAGES_SHOWN) -> str:
    """The first ``first`` instrumented stages (wall and per-node done
    times in ms) and the sums of the walls by kind."""
    parts = []
    for t in st.stage_times[:first]:
        done = "/".join(f"{d * 1e3:.3f}" for d in t.device_done_s)
        parts.append(f"{t.label} {t.wall_s * 1e3:.3f}"
                     + (f" [{done}]" if done else ""))
    sums = {}
    for t in st.stage_times:
        sums[t.kind] = sums.get(t.kind, 0.0) + t.wall_s * 1e3
    occ = st.to_occupancy()
    return ("; ".join(parts) + f"; ... {len(st.stage_times)} stages, walls "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(sums.items()))
            + f"; straggler node's compute {occ.dev_occupancy_s * 1e3:.3f}"
            f" ms")


def phase_mesh(dev, row, errs, card):
    """Session(executor="mesh").run on one phase-3 model (its plan,
    weights and input) with overlap on and off, three runs each (eager,
    capturing, replaying): outputs within TOL of the reference, bit-equal
    across the runs, ExecStats equal to the local run's, no fault counted,
    launches equal to ``mesh_kernel_records``, and every kernel call of
    the eager run (the border strips' too) held against its plain
    version; then the warm run against the local executor's and one
    instrumented run."""
    import torch
    from repro_torch import ExecConfig, Session
    from repro_torch.runtime import engine, mesh_exec

    name = row["model"]
    g, ws, x, plan, out_local, st_local, ref, local_shapes = \
        row["mesh_inputs"]
    wrappers = engine.conv2d_shard, engine.matmul_tiled
    local = Session(g, ws, plan, NODES, ExecConfig(backend="cuda"))
    out = {}
    for overlap in (True, False):
        want = mesh_kernel_records(g, plan, NODES, overlap)
        want_counts = {"conv2d_shard": want[0], "matmul_tiled": want[1]}
        cfg = ExecConfig(backend="cuda", executor="mesh", overlap=overlap)
        sess = Session(g, ws, plan, NODES, cfg)
        check(len(sess.mesh.streams) == NODES,
              f"{name}: the mesh has {len(sess.mesh.streams)} streams")
        mesh_exec.clear_mesh_program_cache()
        outs = []
        calls = {"conv2d_shard": [], "matmul_tiled": []}
        for run in ("eager", "capture", "replay"):
            zero_counts()
            if run == "eager":
                # the stage programs' first calls run the wrappers
                engine.conv2d_shard, engine.matmul_tiled = recorders(calls)
            try:
                o, st = sess.run(x)
            finally:
                engine.conv2d_shard, engine.matmul_tiled = wrappers
            torch.cuda.synchronize()
            counts = read_counts()
            check_counts(f"{name} mesh overlap={overlap} ({run} run)",
                         counts, want_counts)
            check(st == st_local, f"{name} mesh: {run} run ExecStats {st} "
                                  f"!= the local executor's {st_local}")
            check(st.failure_count == 0,
                  f"{name} mesh: {run} run counted {st.failure_count} "
                  f"faults (retries, timeouts, fallbacks)")
            e = rel_err(o, ref)
            check(e < TOL, f"{name} mesh: {run} run vs reference {e}")
            outs.append(o)
        check(all(torch.equal(o, outs[0]) for o in outs),
              f"{name} mesh: eager, capture and replay runs differ")
        n_rec = tuple(len(calls[k]) for k in ("conv2d_shard",
                                              "matmul_tiled"))
        check(n_rec == tuple(want),
              f"{name} mesh overlap={overlap}: recorded {n_rec} calls, "
              f"the plan's records {want}")
        check_recorded(f"{name} mesh overlap={overlap}",
                       calls["conv2d_shard"], calls["matmul_tiled"], errs)
        added = sorted(call_shapes(calls["conv2d_shard"],
                                   calls["matmul_tiled"]) - local_shapes)
        del calls
        print(f"phase 9: {name} mesh overlap={overlap}: the eager run's "
              f"{n_rec[0]} conv2d_shard and {n_rec[1]} matmul_tiled calls "
              f"each within {TOL:g} of its plain version (max abs err so "
              f"far conv2d_shard {errs['conv2d_shard']:.3g}, matmul_tiled "
              f"{errs['matmul_tiled']:.3g}); {len(added)} call shapes the "
              f"local path does not make (kernel, input, weight, "
              f"arguments): "
              + ("; ".join(f"{k} {a}x{b} {' '.join('='.join(c) for c in cs)}"
                           for k, a, b, cs in added[:8])
                 + (" ..." if len(added) > 8 else "") if added else "none"),
              flush=True)
        info = mesh_exec.mesh_program_cache_info()
        # instrumented: eager, capturing, then the replayed run read
        isess = Session(g, ws, plan, NODES,
                        dataclasses.replace(cfg, instrument=True))
        for _ in range(3):
            o, st_i = isess.run(x)
            check(st_i.failure_count == 0 and rel_err(o, ref) < TOL,
                  f"{name} mesh: an instrumented run counted "
                  f"{st_i.failure_count} faults, err {rel_err(o, ref)}")
        kinds = {}
        for t in st_i.stage_times:
            kinds[t.kind] = kinds.get(t.kind, 0) + 1
        check(all(len(t.device_done_s) == NODES for t in st_i.stage_times
                  if t.kind == "compute"),
              f"{name} mesh: a compute stage lacks a node's done time")
        same = torch.equal(outs[0], out_local)
        print(f"phase 9: {name} mesh overlap={overlap}: launches "
              f"conv2d_shard={counts['conv2d_shard']} matmul_tiled="
              f"{counts['matmul_tiled']} == mesh_kernel_records on the "
              f"eager, capture and replay runs (local executor "
              f"{kernel_records(g, plan, NODES)}); the three outputs "
              f"bit-equal, err vs reference {e:.3g}, vs the local executor"
              f" {abs_err(outs[0], out_local):.3g} ("
              f"{'bit-equal' if same else 'not bit-equal'}"
              f"); ExecStats equal to the local run's, failure_count 0; "
              f"programs made {info.misses}, hit {info.hits}; stages "
              f"{dict(sorted(kinds.items()))}", flush=True)
        print(f"phase 9: {name} mesh overlap={overlap} instrumented "
              f"(replayed stages, per-node done from CUDA events in each "
              f"stage's graph; ms, per-node done in brackets): "
              f"{stage_text(st_i)} [{card}]", flush=True)

        # warm runs, the mesh's replayed stages and the local executor's
        # replayed cells in turns
        engine.clear_segment_cache()
        for _ in range(2):
            local.run(x)
        walls = {"local": [], "mesh": []}
        for _ in range(SESSION_REPS):
            walls["local"] += wall_ms(lambda: local.run(x), 1)
            walls["mesh"] += wall_ms(lambda: sess.run(x), 1)
        prof = {k: device_profile(lambda s=s: s.run(x), 3)
                for k, s in (("local", local), ("mesh", sess))}
        (lm, llo, lhi), (mm, mlo, mhi) = (spread(walls["local"]),
                                          spread(walls["mesh"]))
        print(f"phase 9: {name} mesh overlap={overlap}: warm Session.run "
              f"mesh (replayed stages) {mm:.3f} ms (range {mlo:.3f}-"
              f"{mhi:.3f}), local executor (replayed cells) {lm:.3f} ms "
              f"(range {llo:.3f}-{lhi:.3f}); medians of {SESSION_REPS} "
              f"synchronised runs each, in turns; profiled: mesh "
              f"{profile_text(*prof['mesh'][:3], mm)}; local "
              f"{profile_text(*prof['local'][:3], lm)} [{card}]",
              flush=True)
        out[overlap] = dict(mesh_ms=mm, local_ms=lm)
        mesh_exec.clear_mesh_program_cache()
        engine.clear_segment_cache()
        del sess
    return out


def mesh_decode_launches(spec, plan, nodes, n_steps) -> int:
    """flash_decode_paged launches of ``n_steps`` mesh decode steps of
    ``plan``: per step and layer one per node that holds heads — a
    head-sharded layer's owners, every node of a replicated one."""
    from repro_torch.core.partition import Scheme, split_sizes
    per_step = 0
    for i in range(spec.n_layers):
        split = split_sizes(spec.n_heads, nodes) \
            if plan.steps[2 * i][0] == Scheme.OUTC else [spec.n_heads] * nodes
        per_step += sum(1 for h in split if h)
    return per_step * n_steps


def phase_mesh_decode(dev, dec, card):
    """greedy_decode(DecodeSession(executor="mesh")) at OLMo-1B's widths on
    phase 6's weights, plan and prompt, the step one captured graph over
    the node streams: tokens against reference_decode and the local
    session's, logits against both, launches against the plan; then the
    warm step against the local step."""
    import torch
    from repro_torch import DecodeSession, ExecConfig, greedy_decode
    from repro_torch.runtime.graphs import GraphProgram

    spec, w, plan, prompt, toks_l, lg_l, toks_r, lg_r = dec.pop("mesh_inputs")
    n_steps = PROMPT_LEN + N_NEW
    want = mesh_decode_launches(spec, plan, NODES, n_steps)
    kw = dict(page_size=PAGE_SIZE, capacity=CAPACITY)

    def session(executor):
        sess = DecodeSession(spec, w, plan, NODES,
                             ExecConfig(backend="cuda", executor=executor),
                             **kw)
        check(isinstance(sess._step_fn, GraphProgram),
              f"{executor} decode: the step is not a GraphProgram")
        return sess

    sess = session("mesh")
    check(len(sess.mesh.streams) == NODES, "mesh decode: streams")
    zero_counts()
    t0 = time.perf_counter()
    toks, lg = greedy_decode(sess, prompt, N_NEW)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = read_counts()
    check_counts("mesh decode", counts, {"flash_decode_paged": want})
    check_decode_routes("mesh decode", {}, want, 0)
    check(sess._step_fn.graph is not None and sess._step_fn.calls == n_steps,
          "mesh decode: the step was not captured and replayed")
    check(bool(torch.isfinite(lg).all()), "mesh decode: non-finite logits")
    top2 = lg.topk(2, dim=-1).values
    margin = float((top2[:, 0] - top2[:, 1]).min())
    e_r, e_l = rel_err(lg, lg_r), rel_err(lg, lg_l)
    same = torch.equal(lg, lg_l)
    print(f"phase 10: mesh decode olmo-1b widths at {NODES} nodes: "
          f"{PROMPT_LEN} + {N_NEW} tokens in {run_s:.2f} s through the "
          f"captured step; launches flash_decode_paged="
          f"{counts['flash_decode_paged']} == plan {want}; tokens "
          f"{'identical' if toks == toks_r == toks_l else 'DIFFER'} to "
          f"reference_decode and the local session; logits vs "
          f"reference_decode {e_r:.3g}, vs the local replayed step "
          f"{e_l:.3g} ({'bit-equal' if same else 'not bit-equal'}); "
          f"smallest top-two logit margin {margin:.4g}", flush=True)
    check(toks == toks_r, f"mesh decode: tokens {toks} != reference_decode "
                          f"{toks_r} (smallest margin {margin})")
    check(toks == toks_l, f"mesh decode: tokens {toks} != the local "
                          f"session's {toks_l}")
    check(e_r < TOL, f"mesh decode: logits vs reference_decode {e_r}")
    check(e_l < TOL, f"mesh decode: logits vs the local step {e_l}")
    del sess

    # warm per-token step, local and mesh sessions past the same prompt,
    # stepped in turns
    emb = w["emb"]
    sessions = {k: session(k) for k in ("local", "mesh")}
    toks_now = {}
    for k, s in sessions.items():
        toks_now[k] = int(torch.argmax(s.prefill(prompt) @ emb.T))
    steps = {"local": [], "mesh": []}
    for _ in range(N_NEW):
        for k, s in sessions.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = s.step(toks_now[k])
            torch.cuda.synchronize()
            steps[k].append((time.perf_counter() - t0) * 1e3)
            toks_now[k] = int(torch.argmax(h @ emb.T))
    dev_ms = {}
    for k, s in sessions.items():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(N_NEW):
            s._step_fn.graph.replay()
        end.record()
        torch.cuda.synchronize()
        dev_ms[k] = start.elapsed_time(end) / N_NEW
    prof = device_profile(sessions["mesh"]._step_fn.graph.replay, 8)
    (lm, llo, lhi), (mm, mlo, mhi) = spread(steps["local"]), \
        spread(steps["mesh"])
    print(f"phase 10: decode warm step: mesh replayed {mm:.3f} ms per token "
          f"(range {mlo:.3f}-{mhi:.3f}), local replayed {lm:.3f} ms (range "
          f"{llo:.3f}-{lhi:.3f}); medians of {N_NEW} synchronised steps, in "
          f"turns; device time a step ({N_NEW} back-to-back replays between "
          f"CUDA events) mesh {dev_ms['mesh']:.3f} ms, local "
          f"{dev_ms['local']:.3f} ms, so the device idles "
          f"{max(0.0, 1 - dev_ms['mesh'] / mm) * 100:.1f}% of a mesh step "
          f"and {max(0.0, 1 - dev_ms['local'] / lm) * 100:.1f}% of a local "
          f"one; the mesh step's kernels (torch.profiler over 8 replays): "
          f"{profile_text(*prof[:3], mm)} [{card}]", flush=True)
    return dict(mesh_ms=mm, local_ms=lm, mesh_dev_ms=dev_ms["mesh"],
                local_dev_ms=dev_ms["local"])

# ---------------------------------------------------------------------------
# The throughput planner refined on measured mesh occupancy
# ---------------------------------------------------------------------------

def scheme_counts(plan) -> str:
    counts = {}
    for s, _ in plan.steps:
        counts[s.name] = counts.get(s.name, 0) + 1
    nt = sum(1 for _, m in plan.steps if int(m) == 1)
    return (" ".join(f"{k} {v}" for k, v in sorted(counts.items()))
            + f", {nt} NT")


def phase_refine(dev, row, errs, card, estimator=None, tag="phase 11"):
    """The throughput planner's loop on the card: ``refine_with_simulator``
    over the (compute, sync) frontier of one phase-3 model on phase 3's
    4-node, 0.5 Gbps cluster (on ``estimator``'s costs, the analytic
    cluster estimator's by default), each plan it tries run on the mesh
    executor
    (``overlap=False``, ``instrument=True``: eager, capturing, replayed)
    and the replayed run's ``to_occupancy()`` fed back, plus the
    frontier's two extreme plans.  Every plan run is held to the mesh
    contract: within TOL of the reference, the three runs bit-equal,
    ``ExecStats`` equal to the local executor's, no fault counted,
    launches equal to ``mesh_kernel_records``, every kernel call of the
    eager run within TOL of its plain version, and the measured stages
    equal to the port's own ``build_stages`` one for one.  A check that
    fails inside the loop stops the phase: a faulty sample never passes
    as an untrusted step.  Returns the loop's outcome."""
    import torch
    from repro_torch import (AnalyticEstimator, ExecConfig, Session,
                             Testbed, plan_search)
    from repro_torch.cluster import (Objective, OnlineCalibrator,
                                     build_stages, cluster_pipeline_frontier,
                                     cluster_plan_search, homogeneous,
                                     refine_with_simulator)
    from repro_torch.runtime import engine, mesh_exec

    name = row["model"]
    g, ws, x, plan3, _, _, ref, _ = row["mesh_inputs"]
    t_phase = time.perf_counter()
    cl = homogeneous(NODES, bandwidth_gbps=0.5)
    tb = Testbed(nodes=NODES, bandwidth_gbps=0.5)
    check(cl.compat_testbed() == tb,
          f"{name}: compat_testbed {cl.compat_testbed()} != {tb}")
    t0 = time.perf_counter()
    fr = cluster_pipeline_frontier(g, cl, prune_ub=False,
                                   estimator=estimator)
    search_s = time.perf_counter() - t0
    if estimator is None:
        res = plan_search(g, AnalyticEstimator(), tb)
        check(res.plan == plan3,
              f"{name}: plan_search differs from phase 3's")
    else:
        res = cluster_plan_search(g, cl, estimator=estimator)
    i_lat = fr.select(Objective.LATENCY)
    lat_plan = fr.plan(i_lat)
    lat_sum = float(fr.points[i_lat].sum())
    # the frontier's latency point costs what the latency search's plan
    # costs; its plan may be another of the same cost (a tie)
    check(abs(lat_sum - res.cost) <= 1e-12 * res.cost,
          f"{name}: the frontier's latency point {lat_sum} != plan_search's "
          f"cost {res.cost}")
    n_diff = sum(1 for a, b in zip(lat_plan.steps, res.plan.steps) if a != b)
    print(f"{tag}: {name}: frontier of {len(fr)} points built in "
          f"{search_s:.3f} s (prune_ub=False, homogeneous({NODES}, 0.5 "
          f"Gbps) == phase 3's testbed); latency selection point {i_lat} "
          f"costs {lat_sum:.9g} s == plan_search's {res.cost:.9g} s, its "
          f"plan " + ("identical to the latency search's" if not n_diff
                      else f"a tie that differs from the latency search's "
                           f"in {n_diff} steps")
          + f"; THROUGHPUT selection point "
          f"{fr.select(Objective.THROUGHPUT)}", flush=True)

    tried = []

    def measure(plan):
        check(not cuts_fc_columns(g, plan),
              f"{name}: {tag} tried a plan that cuts an FC layer's columns")
        want = mesh_kernel_records(g, plan, NODES, False)
        want_counts = {"conv2d_shard": want[0], "matmul_tiled": want[1]}
        mesh_exec.clear_mesh_program_cache()
        engine.clear_segment_cache()
        out_l, st_l = Session(g, ws, plan, NODES, ExecConfig(
            backend="cuda", device=dev.type)).run(x)
        sess = Session(g, ws, plan, NODES, ExecConfig(
            backend="cuda", executor="mesh", overlap=False, instrument=True,
            device=dev.type))
        wrappers = engine.conv2d_shard, engine.matmul_tiled
        calls = {"conv2d_shard": [], "matmul_tiled": []}
        outs = []
        for run in ("eager", "capture", "replay"):
            zero_counts()
            if run == "eager":
                engine.conv2d_shard, engine.matmul_tiled = recorders(calls)
            try:
                o, st = sess.run(x)
            finally:
                engine.conv2d_shard, engine.matmul_tiled = wrappers
            if dev.type == "cuda":
                torch.cuda.synchronize()
            what = f"{name} refine plan {len(tried)} ({run} run)"
            check_counts(what, read_counts(), want_counts)
            check(st == st_l, f"{what}: ExecStats {st} != the local "
                              f"executor's {st_l}")
            check(st.failure_count == 0,
                  f"{what}: {st.failure_count} faults counted")
            e = rel_err(o, ref)
            check(e < TOL, f"{what}: vs reference {e}")
            outs.append(o)
        check(all(torch.equal(o, outs[0]) for o in outs),
              f"{name} refine plan {len(tried)}: eager, capture and replay "
              f"runs differ")
        n_rec = (len(calls["conv2d_shard"]), len(calls["matmul_tiled"]))
        check(n_rec == tuple(want), f"{name} refine: recorded {n_rec} "
                                    f"calls, the plan's records {want}")
        check_recorded(f"{name} refine plan {len(tried)}",
                       calls["conv2d_shard"], calls["matmul_tiled"], errs)
        v = mesh_exec.validate_stage_decomposition(
            st, build_stages(g, plan, cl))
        check(v["structure_match"], f"{name} refine: stages missing "
                                    f"{v['missing']}, extra {v['extra']}")
        occ = st.to_occupancy()
        tried.append((plan, occ, n_rec, rel_err(outs[0], ref),
                      torch.equal(outs[0], out_l)))
        return occ

    cal = OnlineCalibrator(cl)
    rr = refine_with_simulator(g, cl, max_iters=4, frontier=fr,
                               occupancy_fn=measure, calibrator=cal)
    check(rr.report is None and rr.steps, f"{name}: refine took no step")
    for k, st in enumerate(rr.steps):
        plan, occ, n_rec, e, same = tried[k]
        print(f"{tag}: {name} step {k}: point {st.point_idx} "
              f"({scheme_counts(plan)}), analytic (compute, sync) "
              f"({st.compute_s * 1e3:.4f}, {st.sync_s * 1e3:.4f}) ms, "
              f"measured (dev, link, period) ({st.dev_occupancy_s * 1e3:.4f}"
              f", {st.link_occupancy_s * 1e3:.4f}, {st.sim_period_s * 1e3:.4f}"
              f") ms, beta {st.beta:.6g}, alpha {st.alpha:.6g}; launches "
              f"{n_rec} == mesh_kernel_records, err vs reference {e:.3g}, "
              f"{'bit-equal' if same else 'not bit-equal'} to the local "
              f"executor [{card}]", flush=True)
    beta, alpha = cal.axis_scales()
    last = cal.history[-1]
    print(f"{tag}: {name}: converged={rr.converged} after "
          f"{len(rr.steps)} steps; chosen plan ({scheme_counts(rr.plan)}) "
          f"against the latency plan ({scheme_counts(res.plan)}), "
          f"{'the same plan' if rr.plan == res.plan else 'another plan'}; "
          f"best measured {rr.best_throughput_rps:.1f} runs/s; calibrator "
          f"axis_scales (beta, alpha) ({beta:.6g}, {alpha:.6g}), its last "
          f"sample predicted {last.predicted_period_s * 1e3:.4f} ms against "
          f"{last.measured_period_s * 1e3:.4f} ms measured, corrected "
          f"prediction of the chosen plan "
          f"{cal.predict_period(g, rr.plan) * 1e3:.4f} ms [{card}]",
          flush=True)
    for label, scales in (("compute-heavy", dict(compute_scale=1e6)),
                          ("sync-heavy", dict(sync_scale=1e6))):
        i = fr.select(Objective.THROUGHPUT, **scales)
        plan = fr.plan(i)
        occ = measure(plan)
        _, _, n_rec, e, same = tried[-1]
        print(f"{tag}: {name} extreme {label} point {i} "
              f"({scheme_counts(plan)}), analytic ({fr.points[i, 0] * 1e3:.4f}"
              f", {fr.points[i, 1] * 1e3:.4f}) ms, measured (dev, link, "
              f"period) ({occ.dev_occupancy_s * 1e3:.4f}, "
              f"{occ.link_occupancy_s * 1e3:.4f}, {occ.period_s * 1e3:.4f}) "
              f"ms; launches {n_rec} == mesh_kernel_records, err vs "
              f"reference {e:.3g} [{card}]", flush=True)
    mesh_exec.clear_mesh_program_cache()
    engine.clear_segment_cache()
    n_plans = len({p.steps for p, *_ in tried})
    print(f"{tag}: {name}: {len(tried)} plan runs ({n_plans} distinct "
          f"plans) each within {TOL:g} of the reference, bit-equal across "
          f"eager, capture and replay, ExecStats equal to the local run's, "
          f"failure_count 0, launches equal to mesh_kernel_records, every "
          f"kernel call within {TOL:g} of plain, stages equal to "
          f"build_stages; phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return dict(converged=rr.converged, steps=len(rr.steps), plan=rr.plan,
                rps=rr.best_throughput_rps, frontier=len(fr),
                points=[st.point_idx for st in rr.steps])


# ---------------------------------------------------------------------------
# Phase 12: the data-driven planner (GBDT estimators fit on the card)
# ---------------------------------------------------------------------------

#: benchmarks/estimator_quality.py SMOKE_BUDGET: (traces, trees, depth,
#: hetero_fraction); its evaluation grid
GBDT_BUDGET = (20_000, 60, 7, 0.7)
QUALITY_PRESETS = ("mixed_fast_slow", "stepped")
QUALITY_NODES = (4, 5, 6)
QUALITY_RES = 96
HELD_OUT = 2_000                # held-out traces, seed 99
FRESH_ROWS = 20_000             # step a's fresh rows
PAPER_SAMPLES = 330_000         # TraceConfig()'s default: the paper's 330K
BENCH_ESTIMATOR = ROOT / "benchmarks" / "baselines" / "BENCH_estimator.json"


def flat_equal(a, b) -> bool:
    """Two forests equal bit for bit: bases and every tree's flat arrays."""
    import numpy as np
    return a.base_ == b.base_ and len(a.trees_) == len(b.trees_) and all(
        np.array_equal(p, q) for ta, tb in zip(a.trees_, b.trees_)
        for p, q in zip(ta.flat(), tb.flat()))


def structure_share(a, b) -> float:
    """Share of trees whose structure (features, thresholds, children,
    leaves) is equal in two forests."""
    import numpy as np
    same = sum(all(np.array_equal(p, q) for p, q in
                   zip(ta.flat()[:4] + ta.flat()[5:],
                       tb.flat()[:4] + tb.flat()[5:]))
               for ta, tb in zip(a.trees_, b.trees_))
    return same / max(len(a.trees_), 1)


class Stopwatch:
    """Sums the wall seconds of calls to ``owner.attr`` while active."""

    def __init__(self, owner, attr):
        self.owner, self.attr, self.seconds = owner, attr, 0.0

    def __enter__(self):
        fn = getattr(self.owner, self.attr)

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.seconds += time.perf_counter() - t0
        self._fn = fn
        setattr(self.owner, self.attr, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self._fn)


def cuts_fc_columns(graph, plan) -> bool:
    """An INW or GRID2D step on an FC layer: its seq x 1 map cut into empty
    columns, which the reference cannot run either (its reshape fails,
    ROADMAP C)."""
    from repro_torch.core import Scheme
    from repro_torch.core.graph import ConvT
    return any(s in (Scheme.INW, Scheme.GRID2D) and l.conv_t == ConvT.FC
               for l, (s, _) in zip(graph.layers, plan.steps))


def run_plan_checked(dev, name, g, ws, x, ref, plan, errs, nodes=NODES,
                     timed=True):
    """Phases 3 and 9's contract for one plan on ``nodes`` nodes: the
    local executor's segment programs (eager, captured, replayed) and the
    mesh's stage programs (``overlap=False``; eager run recorded,
    captured, replayed), each within TOL of the unpartitioned reference,
    each executor's runs bit-equal, launches equal to ``kernel_records`` /
    ``mesh_kernel_records``, ``ExecStats`` equal across the executors, no
    fault counted, every recorded kernel call within TOL of its plain
    version; then, if ``timed``, the warm replayed local run's wall and
    device busy time."""
    import torch
    from repro_torch import ExecConfig, Session
    from repro_torch.runtime import engine, mesh_exec

    engine.clear_segment_cache()
    mesh_exec.clear_mesh_program_cache()
    want = kernel_records(g, plan, nodes)
    want_counts = {"conv2d_shard": want[0], "matmul_tiled": want[1]}
    local = Session(g, ws, plan, nodes, ExecConfig(backend="cuda",
                                                   device=dev.type))
    outs = []
    for run in ("eager", "capture", "replay"):
        zero_counts()
        o, st_l = local.run(x)
        torch.cuda.synchronize()
        check_counts(f"{name} local ({run} run)", read_counts(), want_counts)
        check(st_l.failure_count == 0, f"{name}: faults counted locally")
        outs.append(o)
    check(all(torch.equal(o, outs[0]) for o in outs),
          f"{name}: local eager, capture and replay runs differ")
    check(bool(torch.isfinite(outs[0]).all()), f"{name}: non-finite output")
    e_local = rel_err(outs[0], ref)
    check(e_local < TOL, f"{name}: local vs reference {e_local}")

    want_m = mesh_kernel_records(g, plan, nodes, False)
    want_counts = {"conv2d_shard": want_m[0], "matmul_tiled": want_m[1]}
    sess = Session(g, ws, plan, nodes, ExecConfig(
        backend="cuda", executor="mesh", overlap=False, device=dev.type))
    wrappers = engine.conv2d_shard, engine.matmul_tiled
    calls = {"conv2d_shard": [], "matmul_tiled": []}
    mouts = []
    for run in ("eager", "capture", "replay"):
        zero_counts()
        if run == "eager":
            engine.conv2d_shard, engine.matmul_tiled = recorders(calls)
        try:
            o, st = sess.run(x)
        finally:
            engine.conv2d_shard, engine.matmul_tiled = wrappers
        torch.cuda.synchronize()
        check_counts(f"{name} mesh ({run} run)", read_counts(), want_counts)
        check(st == st_l, f"{name} mesh: {run} run ExecStats {st} != the "
                          f"local executor's {st_l}")
        check(st.failure_count == 0, f"{name} mesh: {run} run counted "
                                     f"{st.failure_count} faults")
        mouts.append(o)
    check(all(torch.equal(o, mouts[0]) for o in mouts),
          f"{name}: mesh eager, capture and replay runs differ")
    e_mesh = rel_err(mouts[0], ref)
    check(e_mesh < TOL, f"{name}: mesh vs reference {e_mesh}")
    n_rec = (len(calls["conv2d_shard"]), len(calls["matmul_tiled"]))
    check(n_rec == tuple(want_m),
          f"{name}: recorded {n_rec} calls, the plan's records {want_m}")
    check_recorded(name, calls["conv2d_shard"], calls["matmul_tiled"], errs)
    del calls
    wall = prof = None
    if timed:
        wall = spread(wall_ms(lambda: local.run(x), SESSION_REPS))
        prof = device_profile(lambda: local.run(x), 3)
    engine.clear_segment_cache()
    mesh_exec.clear_mesh_program_cache()
    return dict(wall=wall, prof=prof, err=(e_local, e_mesh), local=want,
                mesh=tuple(want_m))


def phase_gbdt(dev, rows, errs, card):
    """Phase 12, the data-driven planner: GBDT estimators fit on the card
    (against the port's CPU fit and the reference's quality gates), the
    paper's 330K-trace estimator, its Fig. 7/9 row of six plans per model
    run on the card, and phase 11's loop on learned costs."""
    import io
    import numpy as np
    import torch
    from repro_torch import AnalyticEstimator, Testbed, plan_search
    from repro_torch.cluster import (CLUSTER_PRESETS,
                                     ClusterAnalyticEstimator,
                                     ClusterGBDTEstimator,
                                     cluster_plan_search, homogeneous)
    from repro_torch.configs.edge_models import (EDGE_MODELS, mobilenet_v1,
                                                 resnet18)
    from repro_torch.core import GBDTEstimator, Scheme, baselines
    from repro_torch.core.graph import ConvT
    from repro_torch.core.plan import plan_cost
    from repro_torch.gbdt import GBDTRegressor
    from repro_torch.sim import trace

    t_phase = time.perf_counter()
    n_samples, trees, depth, fraction = GBDT_BUDGET
    # train_estimators' settings at this budget
    kw = dict(n_estimators=trees, learning_rate=0.15, max_depth=depth)
    cfgs = {"hom": trace.TraceConfig(n_samples=n_samples, seed=0),
            "het": trace.hetero_trace_config(n_samples=n_samples, seed=0,
                                             hetero_fraction=fraction)}
    held = {"hom": trace.TraceConfig(n_samples=HELD_OUT, seed=99),
            "het": trace.hetero_trace_config(n_samples=HELD_OUT, seed=99,
                                             hetero_fraction=fraction)}
    data, cpu, cpu_s = {}, {}, {}
    t0 = time.perf_counter()
    for kind, cfg in cfgs.items():
        data[(kind, "i")] = trace.generate_i_traces(cfg) + (cfg.seed,)
        data[(kind, "s")] = trace.generate_s_traces(cfg) + (cfg.seed + 7,)
    trace_s = time.perf_counter() - t0
    for key, (x, y, seed) in data.items():
        t0 = time.perf_counter()
        cpu[key] = GBDTRegressor(**kw, seed=seed, device="cpu").fit(x, y)
        cpu_s[key] = time.perf_counter() - t0

    # a. a CPU forest carried to the card through its npz file
    buf = io.BytesIO()
    cpu[("het", "i")].save(buf)
    buf.seek(0)
    moved = GBDTRegressor.load(buf, device=dev)
    fresh, _ = trace.generate_i_traces(trace.hetero_trace_config(
        n_samples=FRESH_ROWS, seed=1, hetero_fraction=fraction))
    p_cpu = cpu[("het", "i")].predict(fresh)
    t0 = time.perf_counter()
    p_dev = moved.predict(fresh)
    torch.cuda.synchronize()
    p_dev_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    p_ref = moved.predict_reference(fresh)
    ref_s = time.perf_counter() - t0
    check(np.array_equal(p_dev, p_cpu), "a: device predict != CPU predict")
    check(np.array_equal(p_dev, p_ref), "a: device predict != "
                                        "predict_reference")
    est_cpu = GBDTEstimator(cpu[("het", "i")], cpu[("het", "s")])
    buf = io.BytesIO()
    cpu[("het", "s")].save(buf)
    buf.seek(0)
    est_moved = GBDTEstimator(moved, GBDTRegressor.load(buf, device=dev))
    cl4 = homogeneous(NODES, bandwidth_gbps=0.5)
    ce_cpu = ClusterGBDTEstimator(est_cpu, cl4)
    ce_dev = ClusterGBDTEstimator(est_moved, cl4)
    tb4 = cl4.compat_testbed()
    rng = np.random.default_rng(3)
    n_scalar = 0
    for _ in range(64):
        layer = trace._random_layer(rng)
        nxt = trace._random_layer(rng)
        p, q = Scheme(int(rng.integers(0, 4))), Scheme(int(rng.integers(0, 4)))
        halo = int(rng.integers(0, 3)) if p.spatial else 0
        a = ce_dev.i_cost(layer, p, tb4, extra_halo=halo)
        check(a == ce_cpu.i_cost(layer, p, tb4, extra_halo=halo),
              "a: scalar i_cost differs between device and CPU forests")
        b = ce_dev.s_cost(layer, nxt, p, q, tb4)
        check(b == ce_cpu.s_cost(layer, nxt, p, q, tb4),
              "a: scalar s_cost differs between device and CPU forests")
        n_scalar += 2
    xs_fresh, _ = trace.generate_s_traces(trace.hetero_trace_config(
        n_samples=FRESH_ROWS, seed=1, hetero_fraction=fraction))
    check(np.array_equal(est_moved.i_cost_batch(fresh, tb4),
                         est_cpu.i_cost_batch(fresh, tb4))
          and np.array_equal(est_moved.s_cost_batch(xs_fresh, tb4),
                             est_cpu.s_cost_batch(xs_fresh, tb4)),
          "a: batched costs differ between device and CPU forests")
    print(f"phase 12a: a CPU-fit hetero i-forest ({trees} trees, depth "
          f"{depth}, {n_samples} traces) saved as npz and loaded on the "
          f"{dev.type}: predict on {FRESH_ROWS} fresh rows bit-equal to the "
          f"CPU predict and to predict_reference (the host's scalar walk, "
          f"{ref_s:.1f} s); device predict {p_dev_ms:.2f} ms for "
          f"{FRESH_ROWS} rows (first call, a copy each way); "
          f"GBDTEstimator / ClusterGBDTEstimator batched costs of "
          f"{FRESH_ROWS} i- and s-rows and {n_scalar} scalar calls equal "
          f"on both devices [{card}]", flush=True)

    # b. device fits against the CPU fits, twice each
    dev_fit, dev_s = {}, {}
    for key, (x, y, seed) in data.items():
        fits = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fits.append(GBDTRegressor(**kw, seed=seed, device=dev).fit(x, y))
            torch.cuda.synchronize()
            dev_s.setdefault(key, []).append(time.perf_counter() - t0)
        check(flat_equal(fits[0], fits[1]),
              f"b: two device fits of {key} differ")
        dev_fit[key] = fits[0]
    for key, model in dev_fit.items():
        kind, which = key
        gen = trace.generate_i_traces if which == "i" else \
            trace.generate_s_traces
        xh, yh = gen(held[kind])
        r_dev = float(np.sqrt(np.mean((model.predict(xh) - yh) ** 2)))
        r_cpu = float(np.sqrt(np.mean((cpu[key].predict(xh) - yh) ** 2)))
        x, y, _ = data[key]
        gap = max(float(np.max(np.abs(model.predict(xh)
                                      - cpu[key].predict(xh)))),
                  float(np.max(np.abs(model.predict(x)
                                      - cpu[key].predict(x)))))
        check(abs(r_dev - r_cpu) <= 0.01 * r_cpu,
              f"b: {key} held-out RMSE {r_dev} vs the CPU fit's {r_cpu}")
        print(f"phase 12b: {kind} {which}-forest ({x.shape[1]} features, "
              f"{n_samples} traces, {trees} trees, depth {depth}): trees of "
              f"equal structure {structure_share(model, cpu[key]) * 100:.1f}"
              f"%, forests bit-equal "
              f"{flat_equal(model, cpu[key])}; largest prediction gap "
              f"{gap:.3g} (training and held-out rows); held-out RMSE "
              f"(log-seconds, seed 99) device {r_dev:.6f} CPU {r_cpu:.6f}; "
              f"fit device {dev_s[key][0]:.2f} s and {dev_s[key][1]:.2f} s "
              f"(two fits, bit-equal), CPU version {cpu_s[key]:.2f} s "
              f"[{card}]", flush=True)
    het = GBDTEstimator(dev_fit[("het", "i")], dev_fit[("het", "s")])
    hom = GBDTEstimator(dev_fit[("hom", "i")], dev_fit[("hom", "s")])
    print(f"phase 12b: traces {trace_s:.1f} s for 4 x {n_samples} on the "
          f"host [{card}]", flush=True)

    # c. benchmarks/estimator_quality.py's gates on the device forests
    committed = json.loads(BENCH_ESTIMATOR.read_text())["presets"]
    graphs = (("mobilenet", mobilenet_v1(QUALITY_RES)),
              ("resnet18", resnet18(QUALITY_RES)))
    for preset in QUALITY_PRESETS:
        het_r, hom_r = [], []
        for _, g in graphs:
            for n in QUALITY_NODES:
                cl = CLUSTER_PRESETS[preset](n)
                tb = cl.compat_testbed()
                oracle = cluster_plan_search(g, cl)
                ae = ClusterAnalyticEstimator(cl)
                ce = ClusterGBDTEstimator(het, cl)
                het_r.append(plan_cost(g, cluster_plan_search(
                    g, cl, estimator=ce).plan, ae, tb) / oracle.cost)
                hom_r.append(plan_cost(g, plan_search(g, hom, tb).plan, ae,
                                       tb) / oracle.cost)
        h, m = float(np.mean(het_r)), float(np.mean(hom_r))
        check(h <= 1.05, f"c: {preset}: hetero ratio {h} > 1.05")
        check(h < m, f"c: {preset}: hetero ratio {h} !< hom ratio {m}")
        c = committed[preset]
        print(f"phase 12c: {preset}: mean plan-cost/oracle over "
              f"{len(het_r)} cells: hetero-trained {h:.4f} (committed "
              f"BENCH_estimator.json {c['hetero_oracle_ratio']:.4f}), "
              f"homogeneous-trained {m:.4f} (committed "
              f"{c['hom_oracle_ratio']:.4f}); hetero_within_5pct True, "
              f"hetero_beats_hom True [{card}]", flush=True)

    # d. the paper's scale
    with Stopwatch(trace, "generate_i_traces") as ti, \
            Stopwatch(trace, "generate_s_traces") as ts, \
            Stopwatch(GBDTRegressor, "fit") as tf:
        est = trace.train_estimators(trace.TraceConfig(
            n_samples=PAPER_SAMPLES), device=dev)
        torch.cuda.synchronize()
    per_tree_row = (cpu_s[("hom", "i")] + cpu_s[("hom", "s")]) / \
        (2 * trees * n_samples)
    cpu_est = per_tree_row * 2 * 120 * PAPER_SAMPLES
    ratios = {}
    tb = Testbed(nodes=4, bandwidth_gbps=1.0)
    for name in ("mobilenet", "resnet18", "bert"):
        g = EDGE_MODELS[name]()
        true = plan_cost(g, plan_search(g, est, tb).plan,
                         AnalyticEstimator(), tb)
        ratios[name] = true / plan_search(g, AnalyticEstimator(), tb).cost
    check(ratios["mobilenet"] <= 1.30,
          f"d: the 330K GBDT plan for MobileNet is {ratios['mobilenet']}x "
          f"the analytic optimum")
    print(f"phase 12d: train_estimators(TraceConfig()): {PAPER_SAMPLES} i- "
          f"and s-traces in {ti.seconds + ts.seconds:.1f} s on the host, two "
          f"forests (120 trees, lr 0.15, depth 7) fit on the {dev.type} in "
          f"{tf.seconds:.1f} s; the CPU version's time per tree-row in b "
          f"scaled to 2 x 120 trees x {PAPER_SAMPLES} rows estimates "
          f"{cpu_est:.0f} s for the same fits (an estimate, not a run); "
          f"GBDT plan priced by the analytic estimator over the analytic "
          f"optimum on Testbed(4, 1.0 Gbps): mobilenet "
          f"{ratios['mobilenet']:.4f} (<= 1.30), resnet18 "
          f"{ratios['resnet18']:.4f}, bert {ratios['bert']:.4f} [{card}]",
          flush=True)

    # e. Fig. 7/9's row on the card: the six solutions of each model
    tb = Testbed(nodes=NODES, bandwidth_gbps=0.5)
    for row in rows:
        name = row["model"]
        g, ws, x, _, _, _, ref, _ = row["mesh_inputs"]
        sols = baselines.all_solutions(g, est, tb)
        est_t, ana_t, wall_t = {}, {}, {}
        for col, (plan, cost) in sols.items():
            est_t[col] = cost
            ana_t[col] = plan_cost(g, plan, AnalyticEstimator(), tb)
            what = (f"phase 12e: {name} {col} ({scheme_counts(plan)}): "
                    f"GBDT estimate {cost * 1e3:.4f} ms, analytic "
                    f"{ana_t[col] * 1e3:.4f} ms")
            if cuts_fc_columns(g, plan):
                print(f"{what}; not run: an INW or GRID2D step on an FC "
                      f"layer, which the reference cannot execute (ROADMAP "
                      f"C) [{card}]", flush=True)
                continue
            r = run_plan_checked(dev, f"{name} {col}", g, ws, x, ref, plan,
                                 errs)
            wall_t[col] = r["wall"][0]
            n_dw = sum(1 for l, (s, _) in zip(g.layers, plan.steps)
                       if s == Scheme.OUTC and l.conv_t == ConvT.DWCONV)
            note = (f"; {n_dw} OutC depthwise layers run at {NODES}x their "
                    f"work (ROADMAP B 12)" if n_dw else "")
            print(f"{what}; launches local {r['local']} mesh {r['mesh']} == "
                  f"kernel_records / mesh_kernel_records, err vs reference "
                  f"local {r['err'][0]:.3g} mesh {r['err'][1]:.3g}, "
                  f"ExecStats equal, no fault; warm replayed local "
                  f"Session.run {r['wall'][0]:.3f} ms (range "
                  f"{r['wall'][1]:.3f}-{r['wall'][2]:.3f}), "
                  f"{profile_text(*r['prof'][:3], r['wall'][0])}{note} "
                  f"[{card}]", flush=True)
        scores = [("GBDT estimate", baselines.performance_scores(est_t)),
                  ("analytic", baselines.performance_scores(ana_t)),
                  ("card wall", baselines.performance_scores(wall_t))]
        print(f"phase 12e: {name} performance_scores (min/t): " + "; ".join(
            f"{label} " + ", ".join(f"{k} {v:.3f}" for k, v in sc.items())
            for label, sc in scores) + f" [{card}]", flush=True)

    # f. phase 11's loop on learned costs (ResNet-18)
    row = next(r for r in rows if r["model"] == "resnet18")
    ce = ClusterGBDTEstimator(het, homogeneous(NODES, bandwidth_gbps=0.5))
    out = phase_refine(dev, row, errs, card, estimator=ce, tag="phase 12f")
    ana = row.get("refine")
    if ana is not None:
        same = "the same plan" if out["plan"] == ana["plan"] else \
            "another plan"
        print(f"phase 12f: resnet18 refine on the GBDT frontier "
              f"({out['frontier']} points, steps {out['points']}, "
              f"converged={out['converged']}, {out['rps']:.1f} runs/s) "
              f"beside the analytic frontier's ({ana['frontier']} points, "
              f"steps {ana['points']}, converged={ana['converged']}, "
              f"{ana['rps']:.1f} runs/s): {same} [{card}]", flush=True)
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)


# ---------------------------------------------------------------------------
# Phase 13: observability on the card, and the elastic planner under churn
# ---------------------------------------------------------------------------

#: where phase 13 writes its Perfetto traces and metrics snapshots
#: (git-ignored, under /build/)
TRACE_DIR = ROOT / "build" / "traces"
#: the reference's churn benchmark's gated presets and scenarios
#: (benchmarks/churn_bench.py GATED_PRESETS, GATED_SCENARIOS, SEED)
CHURN_PRESETS = ("stepped", "mixed_fast_slow")
CHURN_SCENARIOS = ("mixed", "flap")
CHURN_SEED = 0


def check_trace(what, tracer, st, nodes) -> int:
    """The control-track ``stage`` spans of ``tracer`` mirror
    ``st.stage_times`` one to one (count, labels, kinds, order, walls) and
    its ``device`` spans are as many as the stages' node completions, on
    the nodes' tracks; returns the number of device spans."""
    from repro_torch import obs
    spans = tracer.spans(cat=obs.STAGE_CAT, track=obs.CONTROL_TRACK)
    check(len(spans) == len(st.stage_times) > 0,
          f"{what}: {len(spans)} stage spans for {len(st.stage_times)} "
          f"measured stages")
    check([(s["name"], s["args"]["kind"], s["dur"]) for s in spans]
          == [(t.label, t.kind, t.wall_s * 1e6) for t in st.stage_times],
          f"{what}: the stage spans differ from ExecStats.stage_times")
    dev = tracer.spans(cat="device")
    n_done = sum(len(t.device_done_s) for t in st.stage_times)
    check(len(dev) == n_done and {s["track"] for s in dev}
          <= {obs.device_track(d) for d in range(nodes)},
          f"{what}: {len(dev)} device spans for {n_done} node completions")
    return len(dev)


def host_split(tracer, st):
    """Where a traced run's host time goes, from its stage spans (ms):
    the card's work inside the stages (each compute stage's last node
    done; a sync stage has none), the rest of the stage walls (launch or
    replay, copies, the synchronise of ``instrument``), the host between
    stages, and the run's wall."""
    from repro_torch import obs
    spans = tracer.spans(cat=obs.STAGE_CAT, track=obs.CONTROL_TRACK)
    walls = sum(t.wall_s for t in st.stage_times) * 1e3
    done = sum(max(t.device_done_s) for t in st.stage_times
               if t.device_done_s) * 1e3
    gaps = sum(max(0.0, b["ts"] - a["ts"] - a["dur"])
               for a, b in zip(spans, spans[1:])) / 1e3
    return dict(stages=walls, device=done, in_stage=walls - done,
                between=gaps, wall=st.wall_s * 1e3, n=len(spans))


def mesh_runs(dev, what, sess, x, want, ref, st_local, errs, traced):
    """The eager (kernel calls recorded and held against plain), capturing
    and replaying runs of a mesh session, each under a tracer of its own
    if ``traced``: launches equal ``want``, within TOL of ``ref``,
    ``ExecStats`` equal the local run's, no fault, and with a tracer the
    spans one to one.  Returns the outputs, stats and tracers."""
    import torch
    from repro_torch import obs
    from repro_torch.runtime import engine
    wrappers = engine.conv2d_shard, engine.matmul_tiled
    want_counts = {"conv2d_shard": want[0], "matmul_tiled": want[1]}
    calls = {"conv2d_shard": [], "matmul_tiled": []}
    outs, stats, tracers = [], [], []
    for run in ("eager", "capture", "replay"):
        w = f"{what} ({'traced' if traced else 'untraced'} {run} run)"
        tr = obs.set_tracer(obs.Tracer()) if traced else None
        zero_counts()
        if run == "eager":
            engine.conv2d_shard, engine.matmul_tiled = recorders(calls)
        try:
            o, st = sess.run(x)
            if dev.type == "cuda":
                torch.cuda.synchronize()
        finally:
            engine.conv2d_shard, engine.matmul_tiled = wrappers
            obs.set_tracer(None)
        check_counts(w, read_counts(), want_counts)
        check(st == st_local, f"{w}: ExecStats {st} != the local run's")
        check(st.failure_count == 0, f"{w}: {st.failure_count} faults")
        e = rel_err(o, ref)
        check(e < TOL, f"{w}: vs reference {e}")
        if traced:
            check_trace(w, tr, st, sess.nodes)
        outs.append(o)
        stats.append(st)
        tracers.append(tr)
    n_rec = (len(calls["conv2d_shard"]), len(calls["matmul_tiled"]))
    check(n_rec == tuple(want), f"{what}: recorded {n_rec} calls, the "
                                f"plan's records {want}")
    check_recorded(what, calls["conv2d_shard"], calls["matmul_tiled"], errs)
    return outs, stats, tracers


def sim_structure(graph, loaded, validated):
    """Whether the measured (pid 1) and simulated (pid 2) stage spans of
    one loaded trace match (``obs.diff_traces``).  On a DAG they may
    differ only by the two equivalences ``validate_stage_decomposition``
    applies (the measured ``reshard`` stages, the simulator's ``bound@``
    stages a merge subsumes) and by order where the simulator runs
    parallel branches at once and the mesh one after another."""
    from repro_torch import obs
    d = obs.diff_traces(loaded, loaded, measured_pid=1, simulated_pid=2)
    if d["structure_match"]:
        return d, "structure_match"
    if graph.is_chain:
        return d, "mismatch"
    subsumed = {label for _, label in validated["subsumed"]}
    same = (validated["structure_match"]
            and set(d["only_measured"]) <= {"reshard"}
            and set(d["only_simulated"]) <= subsumed)
    return d, ("the same stages up to reshard, the subsumed merges and "
               "the order of parallel branches" if same else "mismatch")


def phase_traced_mesh(dev, row, errs, card):
    """13a: one phase-3 model's plan on the mesh with ``instrument=True``,
    overlap on and off: untraced eager, capturing and replaying runs, one
    traced replay of the programs captured untraced, then traced eager,
    capturing and replaying runs after clearing the programs: all six
    outputs bit-equal, ``ExecStats`` equal to the local run's, no fault,
    launches equal to ``mesh_kernel_records``, every eager kernel call
    within TOL of plain, every traced run's spans one to one with its
    ``stage_times``.  Writes the traced replay (with the plan's simulated
    timeline for overlap off) to TRACE_DIR, loads it back, diffs the two
    timelines, prints the measured-over-simulated skew per kind, where the
    host time goes, and the warm run with tracing off and on in turns."""
    import torch
    from repro_torch import (AnalyticEstimator, ExecConfig, Session,
                             Testbed, obs, plan_search)
    from repro_torch.cluster import build_stages, homogeneous, simulate_trace
    from repro_torch.runtime import mesh_exec

    name = row["model"]
    g, ws, x, plan, _, st_local, ref, _ = row["mesh_inputs"]
    cl = homogeneous(NODES, bandwidth_gbps=0.5)
    # what a user does first: plan, here under a tracer and metrics
    tr_plan = obs.set_tracer(obs.Tracer())
    mx = obs.set_metrics(obs.Metrics())
    try:
        res = plan_search(g, AnalyticEstimator(),
                          Testbed(nodes=NODES, bandwidth_gbps=0.5))
    finally:
        obs.set_tracer(None)
        obs.set_metrics(None)
    check(res.plan == plan, f"{name}: plan_search differs from phase 3's")
    mx.export(str(TRACE_DIR / f"{name}.metrics.json"))
    out = {}
    for overlap in (True, False):
        what = f"{name} mesh overlap={overlap} instrument=True"
        want = mesh_kernel_records(g, plan, NODES, overlap)
        sess = Session(g, ws, plan, NODES, ExecConfig(
            backend="cuda", executor="mesh", overlap=overlap,
            instrument=True, device=dev.type))
        mesh_exec.clear_mesh_program_cache()
        outs, stats, _ = mesh_runs(dev, what, sess, x, want, ref, st_local,
                                   errs, traced=False)
        # the programs were captured untraced: a traced replay of them
        # still records every stage (the spans are host work around it)
        tr = obs.set_tracer(obs.Tracer())
        zero_counts()
        try:
            o, st = sess.run(x)
            if dev.type == "cuda":
                torch.cuda.synchronize()
        finally:
            obs.set_tracer(None)
        w = f"{what} (traced replay of untraced captures)"
        check_counts(w, read_counts(), {"conv2d_shard": want[0],
                                        "matmul_tiled": want[1]})
        check(st == st_local and st.failure_count == 0,
              f"{w}: ExecStats {st} or faults {st.failure_count}")
        n_dev = check_trace(w, tr, st, NODES)
        outs.append(o)
        replay_tr, replay_st = tr, st
        mesh_exec.clear_mesh_program_cache()
        t_outs, t_stats, _ = mesh_runs(dev, what, sess, x, want, ref,
                                       st_local, errs, traced=True)
        outs += t_outs
        check(all(torch.equal(o, outs[0]) for o in outs),
              f"{what}: the traced and untraced runs differ")
        path = TRACE_DIR / f"{name}-overlap{int(overlap)}.trace.json"
        sim_note = ""
        if overlap:
            obs.write_trace(str(path), replay_tr)
        else:
            _, sim_tr = simulate_trace(g, plan, cl, n_requests=1)
            obs.write_trace(str(path), replay_tr, sim_tr)
            v = mesh_exec.validate_stage_decomposition(
                replay_st, build_stages(g, plan, cl))
            check(v["structure_match"], f"{what}: stages missing "
                                        f"{v['missing']}, extra {v['extra']}")
        loaded = obs.load_trace(str(path))
        names = [e["name"] for e in obs.span_events(
            loaded, cat=obs.STAGE_CAT, pid=1, track=obs.CONTROL_TRACK)]
        check(names == [t.label for t in replay_st.stage_times],
              f"{what}: the written trace's stage spans differ")
        if not overlap:
            d, verdict = sim_structure(g, loaded, v)
            check(verdict != "mismatch",
                  f"{what}: measured and simulated timelines differ: only "
                  f"measured {d['only_measured']}, only simulated "
                  f"{d['only_simulated']}")
            skew = obs.stage_skew(v["stages"])
            kinds = {}
            for p in skew["per_stage"]:
                if p["ratio"] is not None:
                    kinds.setdefault(p["kind"], []).append(p["ratio"])
            by_kind = ", ".join(
                f"{k} {sorted(r)[len(r) // 2]:.4g} over {len(r)} stages "
                f"({min(r):.4g}-{max(r):.4g})"
                for k, r in sorted(kinds.items()))
            sim_note = (f"; the plan's simulated timeline "
                        f"(simulate_trace, homogeneous({NODES}, 0.5 Gbps)) in "
                        f"the same file: diff_traces {verdict}, "
                        f"{len(d['pairs'])} paired stages; stage_skew "
                        f"(measured over simulated, replayed stages): "
                        f"median {skew['median_ratio']:.4g}, max |log2| "
                        f"{skew['max_abs_log2']:.4g}; by kind: {by_kind}")
            out["skew"] = skew
        hs = host_split(replay_tr, replay_st)
        print(f"phase 13a: {what}: 3 untraced, 1 traced replay of the "
              f"untraced captures and 3 traced runs (eager, capture, "
              f"replay) bit-equal, each within {TOL:g} of the reference, "
              f"ExecStats equal to the local run's, failure_count 0, "
              f"launches {tuple(want)} == mesh_kernel_records; {hs['n']} "
              f"control-track stage spans == stage_times one to one, "
              f"{n_dev} device spans == the node completions; wrote "
              f"{path.relative_to(ROOT)} and loaded it back{sim_note} "
              f"[{card}]", flush=True)
        print(f"phase 13a: {what}: where the traced replay's "
              f"{hs['wall']:.3f} ms go ({hs['n']} stages, each synchronised "
              f"by instrument): the card's work inside the stages (each "
              f"compute stage's last node done) {hs['device']:.3f} ms, the "
              f"rest of the stage walls (replay launch, copies, the "
              f"synchronise) {hs['in_stage']:.3f} ms, the host between "
              f"stages {hs['between']:.3f} ms, before the first and after "
              f"the last stage {hs['wall'] - hs['stages'] - hs['between']:.3f}"
              f" ms [{card}]", flush=True)
        # tracing off and on, the replayed instrumented run, in turns
        walls = {"off": [], "on": []}
        tr = obs.Tracer()
        for _ in range(SESSION_REPS):
            walls["off"] += wall_ms(lambda: sess.run(x), 1)
            obs.set_tracer(tr)
            try:
                walls["on"] += wall_ms(lambda: sess.run(x), 1)
            finally:
                obs.set_tracer(None)
        (fm, flo, fhi), (nm, nlo, nhi) = (spread(walls["off"]),
                                          spread(walls["on"]))
        print(f"phase 13a: {what}: warm Session.run (replayed stages) "
              f"tracing off {fm:.3f} ms (range {flo:.3f}-{fhi:.3f}), on "
              f"{nm:.3f} ms (range {nlo:.3f}-{nhi:.3f}); medians of "
              f"{SESSION_REPS} synchronised runs each, in turns; host "
              f"clocks move up to 2x, so this is evidence, not a limit "
              f"[{card}]", flush=True)
        out[overlap] = dict(off=fm, on=nm, host=hs, out=outs[0],
                            stages=replay_st.stage_times)
        mesh_exec.clear_mesh_program_cache()
        del sess
    return out


def ordinary_run(dev, what, g, ws, x, plan, want, ref, st_local, clean):
    """After a fault: the next ordinary mesh run (overlap on) meets phase
    9's contract: launches, the clean run's bits, ExecStats, no fault."""
    import torch
    from repro_torch import ExecConfig, Session
    zero_counts()
    o, st = Session(g, ws, plan, NODES, ExecConfig(
        backend="cuda", executor="mesh", device=dev.type)).run(x)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    check_counts(f"{what}: the next ordinary run", read_counts(),
                 {"conv2d_shard": want[0], "matmul_tiled": want[1]})
    check(torch.equal(o, clean) and rel_err(o, ref) < TOL,
          f"{what}: the next ordinary run's output differs")
    check(st == st_local and st.failure_count == 0,
          f"{what}: the next ordinary run's ExecStats {st}, faults "
          f"{st.failure_count}")


def phase_mesh_faults(dev, row, traced, card):
    """13b: faults on the card.  A fault injected once before one stage's
    dispatch with ``stage_retries=1``: one retry counted, a
    ``stage_retry`` record in the flight ring, a ``retry:`` instant on the
    control track, the clean run's bits, launches and ExecStats.  A
    ``stage_timeout_s`` far below one stage's measured wall raises
    ``StageTimeoutError`` and leaves exactly one postmortem whose ring
    holds that stage's dispatch and its timeout.  After each, the next
    ordinary run meets phase 9's contract."""
    import json as _json
    import tempfile
    import threading
    import torch
    from repro_torch import obs
    from repro_torch.runtime import mesh_exec
    from repro_torch.runtime.mesh_exec import (StageTimeoutError,
                                               run_partitioned_mesh)

    name = row["model"]
    g, ws, x, plan, _, st_local, ref, _ = row["mesh_inputs"]
    want = mesh_kernel_records(g, plan, NODES, True)
    clean = traced[True]["out"]

    # a fault that one retry absorbs
    seen = []

    def hook(kind, label, attempt):
        seen.append((kind, label, attempt))
        if len(seen) == 2:
            raise OSError(f"injected fault before {label}")

    mesh_exec.clear_mesh_program_cache()
    obs.get_flight().clear()
    tr = obs.set_tracer(obs.Tracer())
    zero_counts()
    try:
        o, st = run_partitioned_mesh(g, ws, x, plan, NODES, stage_retries=1,
                                     fault_hook=hook, fallback="raise")
        if dev.type == "cuda":
            torch.cuda.synchronize()
    finally:
        obs.set_tracer(None)
    label = seen[1][1]
    ring = [(e["kind"], e.get("label")) for e in obs.get_flight().events()]
    instants = [r["name"] for r in tr._records if r["ph"] == "i"]
    what = f"{name} retry"
    check(st.retries == 1 and st.timeouts == 0 and st.fallbacks == 0,
          f"{what}: counted retries {st.retries}, timeouts {st.timeouts}, "
          f"fallbacks {st.fallbacks}")
    check(("stage_retry", label) in ring and instants == [f"retry:{label}"],
          f"{what}: ring {ring[-4:]}, instants {instants}")
    check_counts(what, read_counts(), {"conv2d_shard": want[0],
                                       "matmul_tiled": want[1]})
    check(torch.equal(o, clean) and st == st_local,
          f"{what}: output or ExecStats differ from the clean run's")
    ordinary_run(dev, what, g, ws, x, plan, want, ref, st_local, clean)
    print(f"phase 13b: {name}: a fault injected before stage {label!r} "
          f"with stage_retries=1: retries 1, a stage_retry record in the "
          f"flight ring ({len(ring)} records), the instant "
          f"{instants[0]!r} on the control track, the clean run's bits, "
          f"launches {tuple(want)} and ExecStats; the next ordinary run "
          f"meets phase 9's contract [{card}]", flush=True)

    # a watchdog far below one stage's wall
    wall = min(t.wall_s for t in traced[False]["stages"])
    timeout = wall * 1e-3
    mesh_exec.clear_mesh_program_cache()
    obs.get_flight().clear()
    with tempfile.TemporaryDirectory(dir=TRACE_DIR) as d:
        obs.set_postmortem_dir(d)
        raised = None
        try:
            run_partitioned_mesh(g, ws, x, plan, NODES,
                                 stage_timeout_s=timeout, fallback="raise")
        except StageTimeoutError as exc:
            raised = exc
        finally:
            obs.set_postmortem_dir(None)
        for th in threading.enumerate():
            if th.name.startswith("mesh-stage:"):
                th.join(120)
                check(not th.is_alive(), f"stage worker {th.name} still "
                                         f"runs 120 s after its timeout")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        check(raised is not None, f"{name}: stage_timeout_s={timeout:g} "
                                  f"raised no StageTimeoutError")
        dumps = sorted(Path(d).glob("postmortem-*-stage_timeout.json"))
        check(len(dumps) == 1, f"{name}: {len(dumps)} timeout postmortems")
        doc = _json.loads(dumps[0].read_text())
    ctx = doc["context"]
    kinds = [(e["kind"], e.get("label")) for e in doc["events"]]
    check(doc["reason"] == "stage_timeout" and ctx["timeout_s"] == timeout
          and ("stage_dispatch", ctx["label"]) in kinds
          and ("stage_timeout", ctx["label"]) in kinds,
          f"{name}: the postmortem {ctx}, ring {kinds}")
    ordinary_run(dev, f"{name} timeout", g, ws, x, plan, want, ref,
                 st_local, clean)
    print(f"phase 13b: {name}: stage_timeout_s={timeout:.3g} s (1e-3 of "
          f"the shortest measured stage, {wall * 1e3:.4f} ms) raised "
          f"StageTimeoutError at stage {ctx['label']!r} and left exactly "
          f"one postmortem-*-stage_timeout.json, its ring {kinds}; the "
          f"abandoned worker joined, the next ordinary run meets phase 9's "
          f"contract [{card}]", flush=True)


def phase_planner_traced(row, card):
    """13c: ``plan_search`` and ``cluster_pipeline_frontier`` for one
    model under a tracer and metrics: the planner spans and the cost
    tables' dedup counters; and phase 11's loop's ``refine.*`` gauges
    (phase 11 ran that model's loop with metrics on)."""
    from repro_torch import AnalyticEstimator, Testbed, obs, plan_search
    from repro_torch.cluster import cluster_pipeline_frontier, homogeneous

    name = row["model"]
    g = row["mesh_inputs"][0]
    tr = obs.set_tracer(obs.Tracer())
    mx = obs.set_metrics(obs.Metrics())
    try:
        plan_search(g, AnalyticEstimator(),
                    Testbed(nodes=NODES, bandwidth_gbps=0.5))
        fr = cluster_pipeline_frontier(g, homogeneous(NODES, 0.5),
                                       prune_ub=False)
    finally:
        obs.set_tracer(None)
        obs.set_metrics(None)
    spans = tr.spans()
    names = [s["name"] for s in spans]
    check(names == ["plan_search.table_build", "plan_search.dp_sweep",
                    "plan_search.reconstruct", "frontier.register",
                    "frontier.evaluate", "frontier.dp"],
          f"{name}: planner spans {names}")
    check(spans[-1]["args"]["points"] == len(fr),
          f"{name}: frontier.dp says {spans[-1]['args']['points']} points")
    counters = mx.snapshot()["counters"]
    check(counters.get('cost_tables.dedup_hits{table="i"}', 0) > 0,
          f"{name}: no dedup hit counted: {counters}")
    obs.write_trace(str(TRACE_DIR / f"{name}-planner.trace.json"), tr)
    mx.export(str(TRACE_DIR / f"{name}-planner.metrics.json"))

    def args(sp):
        return ", ".join(f"{k}={v}" for k, v in sp["args"].items()
                         if k != "graph")
    print(f"phase 13c: {name} planner spans (ms; arguments): " + "; ".join(
        f"{sp['name']} {sp['dur'] / 1e3:.3f} ({args(sp)})" for sp in spans)
        + "; cost-table dedup counters " + ", ".join(
            f"{k} {v:g}" for k, v in sorted(counters.items()))
        + f" [{card}]", flush=True)
    snap = row.get("refine_metrics")
    check(snap is not None and snap["gauges"],
          f"{name}: phase 11 recorded no refine gauges")
    print(f"phase 13c: {name} phase 11 loop with metrics on: " + ", ".join(
        f"{k} {v:.6g}" for k, v in sorted(snap["gauges"].items()))
        + "; " + ", ".join(f"{k} {v:g}" for k, v in
                           sorted(snap["counters"].items())
                           if k.startswith("refine."))
        + "; " + ", ".join(
            f"{k} count {h['count']} sum {h['sum']:.6g}"
            for k, h in sorted(snap["histograms"].items()))
        + f" [{card}]", flush=True)


class ReplanLog:
    """Records every ``ElasticPlanner.replan`` decision made while active,
    with the cluster it planned for and the strategy of the churn replay
    that made it (``run_churn`` wrapped to name its strategy)."""

    def __enter__(self):
        from repro_torch.cluster import churn, elastic
        self.decisions = []
        self._saved = churn.run_churn, elastic.ElasticPlanner.replan
        run, replan = self._saved
        current = {}

        def tagged(graph, cluster, scenario, strategy, **kw):
            current["strategy"] = strategy
            return run(graph, cluster, scenario, strategy, **kw)

        def recorded(planner, cluster, *a, **kw):
            dec = replan(planner, cluster, *a, **kw)
            self.decisions.append((current.get("strategy"), cluster, dec))
            return dec
        churn.run_churn = tagged
        elastic.ElasticPlanner.replan = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.cluster import churn, elastic
        churn.run_churn, elastic.ElasticPlanner.replan = self._saved


def phase_churn(dev, row, errs, card):
    """13d: the elastic planner under churn for one model: the reference
    churn benchmark's gated presets (4 devices) and scenarios, seed 0,
    ``compare_strategies``; the reference's structural claims
    (``tests/test_churn.py``); then every distinct plan the incremental
    strategy adopts, and the plan scratch picks at the same states, run
    on the mesh at its live node count under phases 3 and 9's contract
    (a plan that cuts an FC layer's columns is printed, not run)."""
    from repro_torch import obs
    from repro_torch.cluster import (CHURN_SCENARIOS as SCENARIOS,
                                     CLUSTER_PRESETS, compare_strategies)

    name = row["model"]
    g, ws, x, _, _, _, ref, _ = row["mesh_inputs"]
    adopted = {}                 # (nodes, steps) -> (strategies, plan)
    walls = {"scratch": [], "incremental": []}
    for preset in CHURN_PRESETS:
        cluster = CLUSTER_PRESETS[preset](NODES)
        for sname in CHURN_SCENARIOS:
            scen = SCENARIOS[sname](cluster, seed=CHURN_SEED)
            tr = obs.set_tracer(obs.Tracer())
            mx = obs.set_metrics(obs.Metrics())
            try:
                with ReplanLog() as log:
                    res = compare_strategies(g, cluster, scen)
            finally:
                obs.set_tracer(None)
                obs.set_metrics(None)
            nev, scr, inc = (res["never"], res["scratch"],
                             res["incremental"])
            what = f"{name} {preset}({NODES}) {scen.name}"
            # tests/test_churn.py's structural claims
            check(nev.n_replans == 0 and inc.goodput_rps > nev.goodput_rps,
                  f"{what}: never replanned or incremental's goodput "
                  f"{inc.goodput_rps} <= never's {nev.goodput_rps}")
            check(inc.n_keeps + inc.n_migrations == inc.n_replans
                  and scr.n_keeps == 0 and scr.n_migrations == scr.n_replans,
                  f"{what}: replans do not split into keeps and migrations")
            check(sum(inc.reuse_counts.values()) > 0,
                  f"{what}: incremental reused nothing")
            if sname == "mixed":
                check(scr.goodput_rps > nev.goodput_rps
                      and scr.stall_total_s > 0.0
                      and len(nev.recoveries_s) == len(inc.recoveries_s) > 0
                      and inc.mean_recovery_s < nev.mean_recovery_s,
                      f"{what}: scratch or recovery claims fail")
            else:
                check(inc.reuse_counts.get("frontier_cache", 0) >= 2,
                      f"{what}: flapping hit the frontier cache "
                      f"{inc.reuse_counts.get('frontier_cache', 0)} times")
            detects = [r for r in tr._records
                       if r["ph"] == "i" and r["name"] == "detect"]
            check(len(detects) == scr.n_replans + inc.n_replans,
                  f"{what}: {len(detects)} detect instants")
            for s, r in res.items():
                print(f"phase 13d: {what} {s}: goodput "
                      f"{r.goodput_rps:.3f} rps, mean recovery "
                      f"{r.mean_recovery_s:.4f} s over "
                      f"{len(r.recoveries_s)} faults, {r.n_replans} replans"
                      f" ({r.n_keeps} kept, {r.n_migrations} migrated), "
                      f"plan wall {r.plan_wall_total_s * 1e3:.3f} ms in all"
                      f", stall {r.stall_total_s:.4f} s, reuse "
                      + " ".join(f"{k}={v}" for k, v in
                                 r.reuse_counts.items() if v)
                      + f" [{card}]", flush=True)
            for s, cl, dec in log.decisions:
                if s in walls and dec is not None:
                    walls[s].append(dec.plan_wall_s)
                if s in ("incremental", "scratch"):
                    key = (cl.n, dec.plan.steps)
                    who, _ = adopted.get(key, (set(), None))
                    adopted[key] = (who | {s}, dec.plan)
            spans = {}
            for sp in tr.spans(cat="planner"):
                spans.setdefault(sp["name"], []).append(sp["dur"] / 1e3)
            print(f"phase 13d: {what}: replan spans (count, total ms): "
                  + ", ".join(f"{k} {len(v)} {sum(v):.3f}"
                              for k, v in sorted(spans.items()))
                  + "; counters " + ", ".join(
                      f"{k} {v:g}" for k, v in
                      sorted(mx.snapshot()["counters"].items())
                      if k.startswith("replan."))
                  + f" [{card}]", flush=True)
    for s, w in walls.items():
        w = sorted(w)
        print(f"phase 13d: {name} {s}: {len(w)} replans on this host, plan "
              f"wall median {w[len(w) // 2] * 1e3:.3f} ms (range "
              f"{w[0] * 1e3:.3f}-{w[-1] * 1e3:.3f}), total "
              f"{sum(w) * 1e3:.3f} ms [{card}]", flush=True)
    ran = 0
    for (n, _), (who, plan) in sorted(adopted.items(),
                                      key=lambda kv: (-kv[0][0],
                                                      str(kv[0][1]))):
        label = f"{name} churn plan nodes={n} ({'+'.join(sorted(who))})"
        if cuts_fc_columns(g, plan):
            print(f"phase 13d: {label} ({scheme_counts(plan)}): not run, "
                  f"an INW or GRID2D step on an FC layer (ROADMAP C) "
                  f"[{card}]", flush=True)
            continue
        r = run_plan_checked(dev, label, g, ws, x, ref, plan, errs, nodes=n,
                             timed=False)
        ran += 1
        print(f"phase 13d: {label} ({scheme_counts(plan)}): launches local "
              f"{r['local']} mesh {r['mesh']} == kernel_records / "
              f"mesh_kernel_records, err vs reference local "
              f"{r['err'][0]:.3g} mesh {r['err'][1]:.3g}, ExecStats equal, "
              f"no fault [{card}]", flush=True)
    check(ran > 0, f"{name}: no churn plan ran on the mesh")
    return dict(plans=len(adopted), ran=ran)


def phase_observe(dev, rows, errs, card):
    """Phase 13: traced mesh runs (13a) and faults (13b) on the card, the
    planner traced (13c), the elastic planner's plans under churn run on
    the mesh (13d)."""
    t_phase = time.perf_counter()
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    traced = {row["model"]: phase_traced_mesh(dev, row, errs, card)
              for row in rows}
    mobilenet = next(r for r in rows if r["model"] == "mobilenet")
    phase_mesh_faults(dev, mobilenet, traced["mobilenet"], card)
    phase_planner_traced(mobilenet, card)
    churn = phase_churn(dev, mobilenet, errs, card)
    print(f"phase 13: traces and metrics in "
          f"{TRACE_DIR.relative_to(ROOT)}/; {churn['ran']} of "
          f"{churn['plans']} distinct churn plans run on the mesh; "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return traced


# ---------------------------------------------------------------------------
# Phase 14: the LM substrate's serving path (llama3-8b at full width, bf16)
# ---------------------------------------------------------------------------

#: the reference launcher's defaults at the registry's full llama3-8b
LM_SERVE = ("--arch", "llama3-8b", "--batch", "4", "--prompt-len", "16",
            "--gen", "16")
LM_STEP_TOL = 5e-2              # bf16 decode step vs forward, of scale
LM_LONG = 4096                  # the B = 1 prefill (the chunked range)
LM_DECODE_KEYS = 4096           # the long-context decode kernel case
LM_DECODE_TOL = 1e-3            # the reference's decode == forward (f32)
LM_WALL_REPS = 5
LM_PROMPT = 4                   # 14c: prompt tokens, the rest generated


class LMRecorder:
    """Stand-ins for the models' two attention kernels
    (``repro_torch.models.attention``'s ``flash_attention_kernel`` and
    ``flash_decode_paged``) that call the wrappers (so launches count as
    before) and hold each call at once against its plain version on the
    card: bf16 within BF16_TOL of scale, f32 within TOL; a flash call that
    writes its log-sum-exp (a training forward) has it held within TOL of
    the plain one, whatever the dtype (both score in f32).  A call made
    while a CUDA graph is being captured (a captured LM step's) is passed
    through and not held: its outputs do not exist yet, and a hold would
    read them to the host inside the capture.  The program's first call,
    eager, is held; its replays are held bit-equal to the eager step by
    the phases.  Installed with ``with``; ``calls`` and ``err`` per kernel
    (held calls only), ``lse_calls``, ``lse_err``, the held ``shapes``
    (kernel, out shape, dtype) and ``captured``, the calls passed through
    inside a capture."""

    def __init__(self):
        self.calls = {"flash_attention_bh": 0, "flash_decode_paged": 0}
        self.err = {"flash_attention_bh": 0.0, "flash_decode_paged": 0.0}
        self.abs = dict(self.err)
        self.lse_calls, self.lse_err = 0, 0.0
        self.shapes = set()
        self.captured = {"flash_attention_bh": 0, "flash_decode_paged": 0}

    def _hold(self, kname, out, plain):
        import torch
        e = rel_err(out, plain)
        tol = BF16_TOL if out.dtype == torch.bfloat16 else TOL
        check(e < tol, f"{kname} call {self.calls[kname]} {out.dtype} "
              f"{tuple(out.shape)}: error {e} against plain")
        self.shapes.add((kname, tuple(out.shape), str(out.dtype)))
        self.calls[kname] += 1
        self.err[kname] = max(self.err[kname], e)
        self.abs[kname] = max(self.abs[kname], abs_err(out, plain))

    def __enter__(self):
        import torch
        import repro_torch.models.attention as lm_attn
        from repro_torch.kernels.ref import flash_decode_paged_ref
        self.mod = lm_attn
        self.saved = (lm_attn.flash_attention_kernel,
                      lm_attn.flash_decode_paged)
        flash, decode = self.saved

        def rec_flash(q, k, v, *, causal, window, scale, return_lse=False):
            if torch.cuda.is_current_stream_capturing():
                self.captured["flash_attention_bh"] += 1
                return flash(q, k, v, causal=causal, window=window,
                             scale=scale, return_lse=return_lse)
            if not return_lse:
                out = flash(q, k, v, causal=causal, window=window,
                            scale=scale)
                self._hold("flash_attention_bh", out,
                           plain_attention(q, k, v, causal, window))
                return out
            out, lse = flash(q, k, v, causal=causal, window=window,
                             scale=scale, return_lse=True)
            plain, plain_lse = plain_attention(q, k, v, causal, window,
                                               lse=True)
            self._hold("flash_attention_bh", out, plain)
            e = rel_err(lse, plain_lse)
            n = self.calls["flash_attention_bh"]
            check(e < TOL, f"flash_attention_bh call {n}: lse error {e} "
                  f"against plain")
            self.lse_calls += 1
            self.lse_err = max(self.lse_err, e)
            return out, lse

        def rec_decode(q, kp, vp, table, kv_len, **kw):
            out = decode(q, kp, vp, table, kv_len, **kw)
            if torch.cuda.is_current_stream_capturing():
                self.captured["flash_decode_paged"] += 1
                return out
            self._hold("flash_decode_paged", out, flash_decode_paged_ref(
                q, kp, vp, table, kv_len, **kw))
            return out
        lm_attn.flash_attention_kernel = rec_flash
        lm_attn.flash_decode_paged = rec_decode
        return self

    def __exit__(self, *exc):
        self.mod.flash_attention_kernel, self.mod.flash_decode_paged = \
            self.saved
        return False


def top2_margin(logits):
    """The gap between the largest and second-largest logit of each row."""
    top = logits.float().topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def lm_decode_work(rows, groups, hd, kv_len, esize, ps):
    """(bytes, flops) of one grouped paged decode call: the live K and V
    rows of every pool row read once, q and out, the live table
    entries."""
    pages = -(-kv_len // ps)
    nbytes = esize * (2 * rows * kv_len * hd + 2 * rows * groups * hd) \
        + 4.0 * pages
    return float(nbytes), 4.0 * rows * groups * kv_len * hd


def library_lm_decode(q, k, v, kv_len, groups):
    """One library call for the grouped decode over a contiguous cache:
    the live keys then SDPA with ``enable_gqa``."""
    import torch.nn.functional as F
    B, KV, _, hd = k.shape
    return F.scaled_dot_product_attention(
        q.view(B, KV * groups, 1, hd), k[:, :, :kv_len], v[:, :, :kv_len],
        enable_gqa=True)


def phase_lm_kernels(dev, cfg, served, card):
    """Phase 14d: each attention kernel at the LM's shapes, replayed as a
    CUDA graph, beside its plain version, one library call and its bound;
    returns the kernels line's lm_* figures."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention,
                                                     flash_decode_paged)
    from repro_torch.kernels.ref import flash_decode_paged_ref
    from repro_torch.models.attention import page_size, page_table

    B, P, G = served["batch"], served["prompt"], served["gen"]
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    groups = H // KV
    gen = torch.Generator(device=dev).manual_seed(14)
    bf = torch.bfloat16
    out = {}
    # decode: the served pass (kv_len 1 .. P + G on a cache of P + G keys,
    # once a layer) and one call at LM_DECODE_KEYS keys, pools rotated past
    # the L2
    for name, cap, lens, layers in (
            ("served", P + G, list(range(1, P + G + 1)), cfg.n_layers),
            (f"{LM_DECODE_KEYS} keys", LM_DECODE_KEYS, [LM_DECODE_KEYS], 1)):
        ps = page_size(cap)
        table = page_table(cap, dev)
        pair = 2 * B * KV * cap * hd * 2
        copies = max(1, -(-LONG_DECODE_BYTES // pair)) if cap > 1024 else 1
        caches = [(torch.randn((B, KV, cap, hd), generator=gen,
                               device=dev).to(bf),
                   torch.randn((B, KV, cap, hd), generator=gen,
                               device=dev).to(bf)) for _ in range(copies)]
        q = torch.randn((B * H, hd), generator=gen, device=dev).to(bf)
        pools = [tuple(t.view(B * KV, cap // ps, ps, hd) for t in c)
                 for c in caches]

        def kern():
            return [flash_decode_paged(q, kp, vp, table, n, groups=groups)
                    for kp, vp in pools for n in lens]

        def plain():
            return [flash_decode_paged_ref(q, kp, vp, table, n,
                                           groups=groups)
                    for kp, vp in pools for n in lens]

        def library():
            return [library_lm_decode(q, k, v, n, groups)
                    for k, v in caches for n in lens]
        work = [lm_decode_work(B * KV, groups, hd, n, 2, ps) for n in lens]
        nbytes, flops = sum(w[0] for w in work), sum(w[1] for w in work)
        bound = max(nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS) * 1e3
        r0 = decode_routes()
        k_outs, p_outs = kern(), plain()
        lib_outs = library()
        torch.cuda.synchronize()
        e = max(rel_err(k, lb.reshape(B * H, hd))
                for k, lb in zip(k_outs, lib_outs))
        e_plain = max(rel_err(k, pl) for k, pl in zip(k_outs, p_outs))
        check(e < BF16_TOL and e_plain < BF16_TOL, f"phase 14d decode "
              f"{name}: kernel against gather + sdpa {e}, against plain "
              f"{e_plain}")
        check_decode_routes(f"phase 14d decode {name}", r0, 0, len(k_outs))
        del k_outs, p_outs, lib_outs
        row = dict(ms=graph_ms(kern, reps=10) / copies,
                   plain_ms=graph_ms(plain, reps=3) / copies,
                   library_ms=graph_ms(library, reps=10) / copies,
                   bound_ms=bound, calls=len(lens), layers=layers)
        shape = decode_launch_shape(pools[0][0], pools[0][1], cap // ps,
                                    groups)
        row["shape"] = {k: shape[k] for k in ("group_rows", "splits",
                                              "blocks", "waves")}
        print(f"phase 14d: flash_decode_paged {name} (B{B} H{H} KV{KV} "
              f"hd{hd} bf16, cap {cap}, ps {ps}, {len(lens)} calls "
              f"kv_len {lens[0]}..{lens[-1]}; {copies} cache copies "
              f"rotated): {row['ms'] * 1e3:.2f} us, "
              f"{bound / row['ms'] * 100:.1f}% of the bound {bound * 1e3:.3f} "
              f"us by bytes ({nbytes / 1e6:.3f} MB), plain "
              f"{row['plain_ms'] * 1e3:.2f} us, gather + sdpa "
              f"{row['library_ms'] * 1e3:.2f} us; every call within "
              f"{max(e, e_plain):.3g} of scale of both and on the grouped "
              f"route; decode_shape's pick: {shape_text(shape)} [{card}]",
              flush=True)
        out[name] = row
        del caches, pools
    # prefill: one forward's flash calls at the 4 x (P + G) and the
    # 1 x LM_LONG shapes
    for name, b, s in (("served forward", B, P + G),
                       (f"{LM_LONG} prefill", 1, LM_LONG)):
        q = torch.randn((b, H, s, hd), generator=gen, device=dev).to(bf)
        k = torch.randn((b, KV, s, hd), generator=gen, device=dev).to(bf)
        v = torch.randn((b, KV, s, hd), generator=gen, device=dev).to(bf)
        sc = 1.0 / hd ** 0.5

        def kern():
            return attention(q, k, v, causal=True, window=None, scale=sc)

        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  scale=sc, enable_gqa=True)
        nbytes = 2.0 * (2 * q.numel() + 2 * k.numel())
        flops = 4.0 * hd * attention_pairs(s, True, None) * b * H
        t_b, t_o = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
        e = rel_err(kern(), library())
        check(e < BF16_TOL, f"phase 14d flash {name}: kernel against sdpa "
              f"{e}")
        row = dict(ms=graph_ms(kern, reps=10),
                   plain_ms=graph_ms(lambda: plain_attention(
                       q, k, v, True, None), reps=3),
                   library_ms=graph_ms(library, reps=10),
                   bound_ms=max(t_b, t_o),
                   bound_by="bytes" if t_b >= t_o else "operations",
                   layers=cfg.n_layers)
        print(f"phase 14d: flash_attention_bh {name} (B{b} H{H} KV{KV} S{s} "
              f"hd{hd} causal bf16): {row['ms']:.4f} ms, "
              f"{flops / row['ms'] / 1e9:.1f} TFLOP/s, plain "
              f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms "
              f"by its {sdpa_backend(library)} backend, bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} [{card}]",
              flush=True)
        out[name] = row
        del q, k, v
    served_dec = out["served"]
    long_dec = out[f"{LM_DECODE_KEYS} keys"]
    fwd = [out["served forward"], out[f"{LM_LONG} prefill"]]

    def per_pass(rows, key):
        return sum(r[key] * r["layers"] for r in rows)
    return {
        "flash_decode_paged": {
            **{f"lm_{k}": served_dec[k] * served_dec["layers"]
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            **{f"lm_{LM_DECODE_KEYS}_{k}": long_dec[k]
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            "lm_shape": served_dec["shape"],
            f"lm_{LM_DECODE_KEYS}_shape": long_dec["shape"]},
        "flash_attention_bh": {
            f"lm_{k}": per_pass(fwd, k)
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
        "rows": out,
    }


def lm_batch(cfg, b, s, seed, dev):
    """Seeded numpy tokens (and Whisper's stub audio) on ``dev``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))}
    if cfg.family == "encdec":
        batch["audio_embeds"] = torch.from_numpy(
            (rng.standard_normal((b, cfg.enc_seq, cfg.d_model)) * 0.02)
            .astype(np.float32))
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.zeros((b, cfg.vision_tokens,
                                              cfg.d_model))
    return {k: v.to(dev) for k, v in batch.items()}


def lm_decode_run(model, batch, steps, capacity):
    """``steps`` decode steps of ``batch``'s tokens on a fresh cache; the
    logits ``[B, steps, V]``."""
    import torch
    cache = model.cache_init(batch["tokens"].shape[0], capacity)
    if model.cfg.family == "encdec":
        cache["xlayers"] = model.encode_cross(batch["audio_embeds"])
    out = []
    for t in range(steps):
        logits, cache = model.decode_step(
            cache, batch["tokens"][:, t:t + 1], t)
        out.append(logits[:, 0])
    return torch.stack(out, dim=1)


def phase_lm_reduced(dev, rec, card):
    """Phase 14c: all ten registry archs reduced, f32 on the card (TF32
    off): decode equal to the forward (the reference's 1e-3), the card's
    logits within TOL of scale of the same weights and tokens on the CPU
    (plain versions), the sliding-window ring buffer, and GQA variants
    with 2 and 1 KV heads (so ``groups`` > 1 runs in f32); in each case
    ``serve.generate`` through the captured decode program (LM_PROMPT
    prompt tokens, the rest generated; across the wrap of the ring buffer
    in the window cases) bit-equal to the eager ``generate``."""
    import copy
    import torch
    from repro_torch.configs.registry import ARCH_IDS, get_config
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Model

    seq, cases = 10, []
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32")
        if cfg.moe:     # drop-free routing so teacher forcing == decode
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
        if cfg.family == "vlm":
            cfg = dataclasses.replace(cfg, vision_tokens=0)
        cases.append((arch, cfg, seq, cfg.attn_window or seq))
    base = dataclasses.replace(get_config("llama3-8b").reduced(),
                               dtype="float32")
    for n_kv in (2, 1):
        cases.append((f"llama3-8b n_kv {n_kv}",
                      dataclasses.replace(base, n_kv=n_kv), seq, seq))
    for arch in ("llama3-8b", "zamba2-1.2b"):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32", attn_window=4)
        cases.append((f"{arch} window 4", cfg, 12, 4))
    worst = {"decode_vs_forward": 0.0, "card_vs_cpu": 0.0}
    for i, (name, cfg, steps, cap) in enumerate(cases):
        cpu = Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(i))
        model = copy.deepcopy(cpu).to(dev)
        batch = lm_batch(cfg, 2, steps, i, dev)
        cbatch = {k: v.cpu() for k, v in batch.items()}
        with rec:
            full = model.forward(batch)[0]
            dec = lm_decode_run(model, batch, steps, cap)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(full).all())
              and bool(torch.isfinite(dec).all()),
              f"phase 14c {name}: non-finite logits")
        e_fwd = rel_err(full.cpu(), cpu.forward(cbatch)[0])
        e_dec = rel_err(dec.cpu(), lm_decode_run(cpu, cbatch, steps, cap))
        if "window" in name:      # the last step sees the window only
            d = abs_err(dec[:, -1], full[:, -1])
        else:
            d = abs_err(dec, full)
        check(e_fwd < TOL and e_dec < TOL,
              f"phase 14c {name}: card against cpu forward {e_fwd}, decode "
              f"{e_dec}")
        check(d < LM_DECODE_TOL, f"phase 14c {name}: decode against the "
              f"forward {d}")
        worst["decode_vs_forward"] = max(worst["decode_vs_forward"], d)
        worst["card_vs_cpu"] = max(worst["card_vs_cpu"], e_fwd, e_dec)
        prompts = batch["tokens"][:, :LM_PROMPT]
        audio = batch.get("audio_embeds")
        with rec:
            runs = [serve.generate(model, prompts, steps - LM_PROMPT, audio,
                                   eager=eager) for eager in (False, True)]
        torch.cuda.synchronize()
        check(torch.equal(runs[0].tokens, runs[1].tokens)
              and len(runs[0].step_logits) == steps
              and all(torch.equal(a, b) for a, b in zip(
                  runs[0].step_logits, runs[1].step_logits)),
              f"phase 14c {name}: the captured decode differs from the "
              f"eager one")
        del model, cpu, runs
    print(f"phase 14c: {len(cases)} reduced f32 cases on the card (10 "
          f"archs, llama3-8b at 2 and 1 KV heads, window 4 on llama3-8b "
          f"and zamba2): decode against the forward max abs "
          f"{worst['decode_vs_forward']:.3g} (< {LM_DECODE_TOL}), card "
          f"against the CPU's plain versions {worst['card_vs_cpu']:.3g} of "
          f"scale (< {TOL}); generate through the captured decode program "
          f"({LM_PROMPT} prompt tokens, the rest generated) bit-equal to "
          f"the eager generate in every case, tokens and logits [{card}]",
          flush=True)
    return worst


def lm_roofline_ms(arch, shape) -> float:
    """The dry run's roofline, max(t_compute, t_memory) in ms, of one
    step of ``arch`` at ``shape`` (seq, batch, mode) on the one-card
    mesh (counted on fake tensors, the H100's constants)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    rec = dryrun.run_one(arch, shape, mesh=make_local_mesh(), verbose=False)
    return max(rec["t_compute_s"], rec["t_memory_s"]) * 1e3


def step_walls_text(walls, roof, unit="step") -> str:
    """Each of ``walls`` (name: ms list) as median [min, max] and over the
    roofline ``roof`` ms."""
    parts = []
    for name, w in walls.items():
        med, lo, hi = spread(w)
        parts.append(f"{name} {unit} {med:.3f} [{lo:.3f}, {hi:.3f}] ms = "
                     f"{med / roof:.2f}x the roofline")
    return "; ".join(parts)


def phase_lm(dev, errs, card):
    """Phase 14: the LM substrate's serving path.  (b) llama3-8b at full
    width in bf16 through ``repro_torch.launch.serve.main``, every step
    one replay of the captured decode program (its eager first call held
    against plain), then ``generate`` eagerly on the same prompts with
    every kernel call held against plain: tokens and every step's logits
    bit-equal; ``prefill``; (c) the ten archs reduced in f32, captured
    decode and train steps against eager; (d) the eager and the replayed
    step's walls in turns over the dry run's roofline, and the attention
    kernels at the LM's shapes.  Returns the kernels line's lm_*
    figures."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.runtime.steps import capture_decode_step

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = dict(zip(LM_SERVE[::2], LM_SERVE[1::2]))
    B, P, G = (int(args[k]) for k in ("--batch", "--prompt-len", "--gen"))
    argv = [*LM_SERVE, "--full"]
    zero_counts()
    rec_prog = LMRecorder()
    t0 = time.perf_counter()
    with rec_prog:
        res = serve.main(argv)
    torch.cuda.synchronize()
    served_s = time.perf_counter() - t0
    model, cfg = res.model, res.model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    check(cfg.dtype == "bfloat16" and cfg.n_layers == 32
          and cfg.d_model == 4096 and (cfg.n_heads, cfg.n_kv) == (32, 8)
          and cfg.d_ff == 14336 and cfg.vocab == 128256,
          f"phase 14: not llama3-8b at full width: {cfg}")
    steps = P + G
    counts = read_counts()
    check_counts("phase 14 serve", counts,
                 {"flash_decode_paged": cfg.n_layers * steps})
    # every call has 4 query rows a KV head: the grouped route, eager and
    # replayed
    check_decode_routes("phase 14 serve", {}, 0, cfg.n_layers * steps)
    check(rec_prog.calls["flash_decode_paged"] == cfg.n_layers
          and rec_prog.captured["flash_decode_paged"] == cfg.n_layers,
          f"phase 14b: the program's eager call held {rec_prog.calls}, "
          f"its capture passed {rec_prog.captured} through; "
          f"{cfg.n_layers} each expected")
    lm = {"flash_decode_paged": {"lm_launches":
                                 counts["flash_decode_paged"],
                                 "lm_routes": decode_routes()},
          "flash_attention_bh": {"lm_launches": 0}}
    print(f"phase 14b: serve.main({' '.join(argv)}): llama3-8b bf16, "
          f"{cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads "
          f"over {cfg.n_kv} KV heads, hd {cfg.hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}: {n_params / 1e9:.3f} B parameters made on the card "
          f"from seed 0; {B} x ({P} prompt + {G} generated) tokens in "
          f"{served_s:.1f} s (weights included), every step through one "
          f"captured decode program (its first call eager, its second the "
          f"capture); prompt {res.prefill_ms:.1f} ms (warm-up and capture "
          f"included), {res.decode_ms_per_token:.3f} ms a generated token "
          f"(replays); launches {counts} (the program's counts: its eager "
          f"call's {cfg.n_layers} held against plain, max "
          f"{rec_prog.err['flash_decode_paged']:.3g} of scale), decode by "
          f"route {decode_routes()} [{card}]", flush=True)

    # the same prompts eagerly, every kernel call held against plain: the
    # captured run's tokens and logits, bit for bit
    rec = LMRecorder()
    r0 = decode_routes()
    with rec:
        eager = serve.generate(model, res.prompts, G, eager=True)
    torch.cuda.synchronize()
    check_decode_routes("phase 14b eager generate", r0, 0,
                        cfg.n_layers * steps)
    n_equal = sum(torch.equal(a, b) for a, b in zip(eager.step_logits,
                                                    res.step_logits))
    check(torch.equal(eager.tokens, res.tokens) and n_equal == steps
          and len(res.step_logits) == steps,
          f"phase 14b: the captured decode differs from the eager one: "
          f"tokens equal {torch.equal(eager.tokens, res.tokens)}, "
          f"{n_equal} of {steps} steps' logits bit-equal")
    check(rec.calls["flash_decode_paged"] == cfg.n_layers * steps,
          f"phase 14b: {rec.calls} recorded decode calls")
    print(f"phase 14b: generate(eager=True) on the same prompts: tokens "
          f"and all {steps} steps' logits bit-equal to the captured run's; "
          f"{rec.calls['flash_decode_paged']} eager decode calls held "
          f"against plain (max {rec.err['flash_decode_paged']:.3g} of "
          f"scale), all on the grouped route; eager "
          f"{eager.decode_ms_per_token:.3f} ms a generated token [{card}]",
          flush=True)

    # prefill forwards: the served tokens, then B = 1 at LM_LONG
    toks = torch.cat([res.prompts, res.tokens], dim=1)
    zero_counts()
    with rec:
        full = model.prefill({"tokens": toks})
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts("phase 14 prefill", counts,
                 {"flash_attention_bh": cfg.n_layers})
    lm["flash_attention_bh"]["lm_launches"] += counts["flash_attention_bh"]
    steps_logits = torch.stack(res.step_logits, dim=1)
    e = rel_err(steps_logits, full)
    err_abs = abs_err(steps_logits, full)
    check(e < LM_STEP_TOL, f"phase 14b: decode steps against the forward "
          f"{e} of scale")
    margin = top2_margin(full[:, P - 1:-1])
    decided = margin > 2 * err_abs
    fwd_tok = full[:, P - 1:-1].argmax(-1)
    check(bool((fwd_tok == res.tokens)[decided].all()),
          "phase 14b: a greedy token differs from the forward's where the "
          "margin exceeds twice the error")
    long_toks = torch.randint(0, cfg.vocab, (1, LM_LONG),
                              generator=torch.Generator(device=dev)
                              .manual_seed(1), device=dev)
    zero_counts()
    with rec:
        long_logits = model.prefill({"tokens": long_toks})
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts("phase 14 long prefill", counts,
                 {"flash_attention_bh": cfg.n_layers})
    lm["flash_attention_bh"]["lm_launches"] += counts["flash_attention_bh"]
    check(long_logits.shape == (1, LM_LONG, cfg.vocab)
          and bool(torch.isfinite(long_logits).all()),
          f"phase 14b: the {LM_LONG}-token prefill gave "
          f"{tuple(long_logits.shape)} with non-finite values")
    del long_logits
    print(f"phase 14b: {steps} decode steps against the forward of the same "
          f"{B} x {steps} tokens: {e:.4g} of scale (< {LM_STEP_TOL}), max "
          f"abs {err_abs:.4g}; greedy tokens equal the forward's at all "
          f"{int(decided.sum())} of {decided.numel()} positions whose top-two "
          f"margin exceeds twice that (smallest margin "
          f"{float(margin.min()):.4g}); {LM_LONG}-token prefill finite; "
          f"recorded calls held against plain: "
          f"{rec.calls['flash_decode_paged']} decode (max "
          f"{rec.err['flash_decode_paged']:.3g} of scale), "
          f"{rec.calls['flash_attention_bh']} flash (max "
          f"{rec.err['flash_attention_bh']:.3g}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]",
          flush=True)

    # walls: the eager step and the replayed step in turns, each on its
    # own cache filled with the same prompt, then one step of each under
    # the profiler, then the two forwards
    caches = [model.cache_init(B, steps) for _ in range(2)]
    prog = capture_decode_step(model, caches[1], B)
    for t in range(P):
        model.decode_step(caches[0], res.prompts[:, t:t + 1], t)
        prog(caches[1], res.prompts[:, t:t + 1], t)
    walls = {"eager": [], "replayed": []}
    for i, t in enumerate(range(P, steps)):
        tok = res.tokens[:, i:i + 1]
        w = walls_in_turns({
            "eager": lambda: model.decode_step(caches[0], tok, t),
            "replayed": lambda: prog(caches[1], tok, t)}, 1)
        for k in walls:
            walls[k] += w[k]
    last = res.tokens[:, -1:]
    prof = {"eager": device_profile(
                lambda: model.decode_step(caches[0], last, steps - 1), 3),
            "replayed": device_profile(
                lambda: prog(caches[1], last, steps - 1), 3)}
    roof = lm_roofline_ms("llama3-8b", (steps, B, "decode"))
    for name, (n_k, dev_ms, busy_ms, by_name) in prof.items():
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        print(f"phase 14d: one warm {name} decode step (torch.profiler over "
              f"3): {profile_text(n_k, dev_ms, busy_ms, spread(walls[name])[0])}"
              f"{'' if name == 'eager' else ', one graph launch a step'}; "
              "largest: " + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top)
              + f" [{card}]", flush=True)
    fwd_walls = wall_ms(lambda: model.prefill({"tokens": toks}),
                        LM_WALL_REPS)
    long_walls = wall_ms(lambda: model.prefill({"tokens": long_toks}),
                         LM_WALL_REPS)
    med = {k: spread(w)[0] for k, w in walls.items()}
    print(f"phase 14d: warm decode step walls in turns over {G} positions "
          f"(ms, median [min, max]): {step_walls_text(walls, roof)} (the "
          f"dry run's roofline {roof:.4f} ms at B {B}, capacity {steps}); "
          f"{B * 1e3 / med['eager']:.1f} tokens/s eager, "
          f"{B * 1e3 / med['replayed']:.1f} replayed; eager over replayed "
          f"{med['eager'] / med['replayed']:.2f}x; prefill {B} x {steps} "
          "{:.3f} [{:.3f}, {:.3f}]; prefill 1 x {} {:.3f} [{:.3f}, {:.3f}] "
          "[{}]".format(*spread(fwd_walls), LM_LONG, *spread(long_walls),
                        card), flush=True)
    for kname in ("flash_decode_paged", "flash_attention_bh"):
        errs[kname] = max(errs[kname], rec.abs[kname], rec_prog.abs[kname])
    served = dict(batch=B, prompt=P, gen=G)
    del res, eager, full, caches, prog, toks, long_toks
    kern = phase_lm_kernels(dev, cfg, served, card)
    del model
    torch.cuda.empty_cache()
    rec14c = LMRecorder()
    phase_lm_reduced(dev, rec14c, card)
    for kname in ("flash_decode_paged", "flash_attention_bh"):
        errs[kname] = max(errs[kname], rec14c.abs[kname])
        lm[kname].update(kern[kname])
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    return lm



#: phase 15: olmo-1b trained at full width in bf16 through the launcher
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = "olmo-1b", 8, 4, 2048
TRAIN_WARM = 2                  # steps left out of the warm walls
TRAIN_TURNS = 3                 # 15d: eager and replayed steps in turns
#: 15b: olmo-1b's widths at 2 layers, kernel forward against plain
GRAD_LAYERS, GRAD_BATCH, GRAD_SEQ = 2, 2, 2048
#: 15c: the reduced archs' batch (rows, tokens); llama3-8b with accum 2
REDUCED_BATCH, REDUCED_SEQ, ACCUM_ARCH = 4, 24, "llama3-8b"
REDUCED_STEPS = 3               # 15c: captured against eager steps
TRAIN_SCHED = dict(peak_lr=1e-3, warmup=0, total=4)   # lr = peak at step 0
ADAMW_TOL = 1e-6                # AdamW on the same gradients, of scale


def train_flash_launches(cfg, accum=1) -> int:
    """flash_attention_bh launches of one train step: each GQA
    self-attention in a checkpointed block runs twice (forward, and the
    recompute in the backward); Zamba2's shared attention block runs
    outside the checkpoint, once; MLA and RWKV have none."""
    if cfg.mla or cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        every = cfg.hybrid_attn_every or cfg.n_layers
        return accum * -(-cfg.n_layers // every)
    return accum * 2 * (cfg.n_layers + cfg.n_enc_layers)


class PlainSelfAttention:
    """Within ``with``, ``gqa_full``'s self-attention is the plain version
    under plain autograd (``flash_attention_ref``), not the kernel's
    autograd Function: the reference of phase 15b."""

    class _Plain:
        @staticmethod
        def apply(q, k, v, causal, window, scale, grad):
            from repro_torch.kernels.ref import flash_attention_ref
            return flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale)

    def __enter__(self):
        import repro_torch.models.attention as lm_attn
        self.mod, self.saved = lm_attn, lm_attn.FlashSDPA
        lm_attn.FlashSDPA = self._Plain
        return self

    def __exit__(self, *exc):
        self.mod.FlashSDPA = self.saved
        return False


def train_batch(cfg, b, s, seed, dev):
    """``SyntheticLMDataset(seed)``'s batch 0 on ``dev`` (int64 tokens)."""
    import torch
    from repro_torch.data import SyntheticLMDataset
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=s, global_batch=b,
                            seed=seed)
    return {k: torch.from_numpy(v).long().to(dev)
            for k, v in ds.batch(0).items()}


def kernel_share(by_name):
    """(flash ms, cuBLAS ms, other ms) of a profile's kernels by name."""
    flash = sum(v for k, v in by_name.items() if "flash_kernel" in k)
    blas = sum(v for k, v in by_name.items() if "flash_kernel" not in k
               and any(t in k.lower() for t in ("gemm", "xmma", "nvjet",
                                                "cutlass", "cublas")))
    return flash, blas, sum(by_name.values()) - flash - blas


def phase_train_walls(dev, res, eager_ms, card):
    """Phase 15d: the full-width step's walls, train.main's replays beside
    the eager run's steps, then the replayed and the eager step in turns
    over the dry run's roofline, one warm step of each under
    ``torch.profiler``, the AdamW pass alone, the flash kernel at the
    step's shape (forward with lse) and the plain flash backward, each a
    step's worth; returns the kernels line's train_* fields."""
    import torch
    from repro_torch.kernels.flash_attention import attention
    from repro_torch.models.attention import flash_backward
    from repro_torch.optim import adamw_update, cosine_schedule
    from repro_torch.runtime.steps import loss_and_grads, make_train_step

    model, cfg = res.model, res.model.cfg
    med, lo, hi = spread(res.step_ms[TRAIN_WARM:])
    emed, elo, ehi = spread(eager_ms[TRAIN_WARM:])
    flops = 6.0 * res.n_params * res.tokens_per_step
    print(f"phase 15d: train.main's replayed steps ({TRAIN_WARM}.."
          f"{TRAIN_STEPS - 1}) median {med:.1f} ms [{lo:.1f}, {hi:.1f}], "
          f"its first (the program's eager warm-up) {res.step_ms[0]:.1f} "
          f"ms and second (the capture, then a replay) "
          f"{res.step_ms[1]:.1f} ms; the eager run's steps "
          f"{emed:.1f} ms [{elo:.1f}, {ehi:.1f}]; "
          f"{res.tokens_per_step / med * 1e3:.0f} tokens/s replayed, "
          f"{res.tokens_per_step / emed * 1e3:.0f} eager; model-flops share "
          f"6 N T / (step x 989 TFLOP/s) = "
          f"{flops / (med / 1e3) / PEAK_BF16_FLOPS * 100:.1f}% replayed (N "
          f"{res.n_params}, T {res.tokens_per_step}); peak memory "
          f"{res.peak_bytes / 2 ** 30:.2f} GiB (train.main) [{card}]",
          flush=True)

    step = make_train_step(model, total=TRAIN_STEPS,
                           warmup=max(1, TRAIN_STEPS // 10))
    batch = train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, 1, dev)
    opt = res.opt_state
    runs = {"eager": lambda: step(model, opt, batch),
            "replayed": lambda: res.program(model, opt, batch)}
    walls = walls_in_turns(runs, TRAIN_TURNS)
    roof = lm_roofline_ms(TRAIN_ARCH, (TRAIN_SEQ, TRAIN_BATCH, "train"))
    meds = {k: spread(w)[0] for k, w in walls.items()}
    print(f"phase 15d: warm step walls in turns: "
          f"{step_walls_text(walls, roof)} (the dry run's roofline "
          f"{roof:.3f} ms); eager over replayed "
          f"{meds['eager'] / meds['replayed']:.3f}x [{card}]", flush=True)
    shares = {}
    for name, run in runs.items():
        n_k, dev_ms, busy_ms, by_name = device_profile(run, 1)
        flash_ms, blas_ms, other_ms = kernel_share(by_name)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        shares[name] = (dev_ms, flash_ms)
        print(f"phase 15d: one warm {name} step under torch.profiler: "
              f"{profile_text(n_k, dev_ms, busy_ms, meds[name])}; "
              f"flash_attention_bh {flash_ms:.2f} ms, cuBLAS {blas_ms:.2f} "
              f"ms, the rest {other_ms:.2f} ms; largest: "
              + "; ".join(f"{k[:60]} {v:.2f} ms" for k, v in top)
              + f" [{card}]", flush=True)
    dev_ms, flash_ms = shares["replayed"]

    _, grads = loss_and_grads(model, batch)
    params = dict(model.named_parameters())
    lr = cosine_schedule(opt["step"], peak_lr=3e-4, warmup=1,
                         total=TRAIN_STEPS)
    _, adam_ms, _, adam_names = device_profile(
        lambda: adamw_update(grads, opt, params, lr), 1)
    del grads
    torch.cuda.empty_cache()

    # the flash kernel (forward with lse) and the plain backward at the
    # step's shape, one layer's call each, times the step's calls
    gen = torch.Generator(device=dev).manual_seed(15)
    H, hd = cfg.n_heads, cfg.hd
    shape = (TRAIN_BATCH, H, TRAIN_SEQ, hd)
    q, k, v, dout = (torch.randn(shape, generator=gen, device=dev)
                     .to(torch.bfloat16) for _ in range(4))
    sc = hd ** -0.5
    out, lse = attention(q, k, v, causal=True, window=None, scale=sc,
                         return_lse=True)
    fwd_ms = graph_ms(lambda: attention(q, k, v, causal=True, window=None,
                                        scale=sc, return_lse=True), reps=10)
    bwd_ms = graph_ms(lambda: flash_backward(q, k, v, out, lse, dout,
                                             causal=True, window=None,
                                             scale=sc), reps=3)
    lib = train_library_ms(q, k, v, sc)
    launches = train_flash_launches(cfg)
    pairs = attention_pairs(TRAIN_SEQ, True, None) * TRAIN_BATCH * H
    # each input read once, out and the f32 lse written once
    nbytes = 2.0 * 4 * q.numel() + 4.0 * lse.numel()
    t_b = nbytes / PEAK_BYTES * 1e3
    t_o = 4.0 * hd * pairs / PEAK_BF16_FLOPS * 1e3
    bound, by = max(t_b, t_o), "bytes" if t_b >= t_o else "operations"
    print(f"phase 15d: AdamW pass over {len(params)} tensors "
          f"({res.n_params} weights) "
          + (f"{adam_ms:.2f} ms of kernels ({len(adam_names)} kernel names)"
             if adam_ms is not None else "not measured")
          + f"; flash_attention_bh at {list(shape)} bf16 causal with lse "
          f"{fwd_ms:.3f} ms a call ({4.0 * hd * pairs / fwd_ms / 1e9:.1f} "
          f"TFLOP/s; bound {bound:.4f} ms by {by}), x {launches} a "
          f"step = {fwd_ms * launches:.2f} ms; the library forward with its "
          "log-sum-exp (causal, graph replay): " + ", ".join(
              f"{name} {ms:.4f} ms" if ms is not None else f"{name} not "
              f"available" for name, ms in lib.items())
          + f"; the "
          f"plain flash backward (the reference's _flash_bwd, PyTorch ops) "
          f"{bwd_ms:.3f} ms a call, x {cfg.n_layers} a step = "
          f"{bwd_ms * cfg.n_layers:.2f} ms [{card}]", flush=True)
    return {"train_launches": launches,
            "train_ms": fwd_ms * launches,
            "train_bound_ms": bound * launches,
            "train_library_ms": min(ms for ms in lib.values()
                                    if ms is not None) * launches,
            "train_profile_ms": flash_ms if dev_ms is not None else None,
            "train_plain_bwd_ms": bwd_ms * cfg.n_layers,
            "train_step_ms": meds["replayed"],
            "train_eager_step_ms": meds["eager"]}


def train_library_ms(q, k, v, scale) -> dict:
    """ms a call of PyTorch's SDPA forward that writes the log-sum-exp
    (what the training forward needs), causal, graph-replayed: the flash
    backend (``aten._scaled_dot_product_flash_attention``, which must run)
    and the cuDNN one (``aten._scaled_dot_product_cudnn_attention``, None
    where this build or card refuses it)."""
    import torch
    aten = torch.ops.aten

    def flash():
        return aten._scaled_dot_product_flash_attention(
            q, k, v, 0.0, True, False, scale=scale)

    def cudnn():
        return aten._scaled_dot_product_cudnn_attention(
            q, k, v, None, True, 0.0, True, False, scale=scale)
    out = {"SDPA flash": graph_ms(flash, reps=10)}
    try:
        out["SDPA cuDNN"] = graph_ms(cudnn, reps=10)
    except RuntimeError as e:
        print(f"phase 15d: SDPA cuDNN with lse refused: {str(e)[:120]}",
              flush=True)
        out["SDPA cuDNN"] = None
    return out


def phase_train_grads(dev, card):
    """Phase 15b: olmo-1b's widths at GRAD_LAYERS layers, f32 and bf16:
    every gradient through the kernel forward (each call's out and lse held
    against plain as it runs) against the one through the plain forward
    under autograd; every parameter with a plain gradient has one from the
    kernel forward."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import Model
    from repro_torch.runtime.steps import loss_and_grads

    worst = {}
    for dtype, tol in (("float32", TOL), ("bfloat16", BF16_TOL)):
        cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                                  n_layers=GRAD_LAYERS, dtype=dtype)
        model = Model(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(15))
        model.requires_grad_(True)
        batch = train_batch(cfg, GRAD_BATCH, GRAD_SEQ, 15, dev)
        rec = LMRecorder()
        zero_counts()
        with rec:
            loss_k, g_k = loss_and_grads(model, batch)
        torch.cuda.synchronize()
        want = train_flash_launches(cfg)
        check_counts(f"phase 15b {dtype} kernel forward", read_counts(),
                     {"flash_attention_bh": want})
        check(rec.lse_calls == want, f"phase 15b {dtype}: {rec.lse_calls} "
              f"calls wrote lse, {want} expected")
        zero_counts()
        with PlainSelfAttention():
            loss_p, g_p = loss_and_grads(model, batch)
        torch.cuda.synchronize()
        check_counts(f"phase 15b {dtype} plain forward", read_counts(), {})
        e_loss = abs(float(loss_k) - float(loss_p)) / max(1.0, abs(float(
            loss_p)))
        check(e_loss < tol, f"phase 15b {dtype}: loss {float(loss_k)} "
              f"against plain {float(loss_p)}")
        e_grad, live = 0.0, 0
        for n, gp in g_p.items():
            gk = g_k[n]
            if float(gp.abs().max()) > 0:
                live += 1
                check(float(gk.abs().max()) > 0, f"phase 15b {dtype}: {n} "
                      f"has no gradient through the kernel forward")
            e = rel_err(gk, gp)
            check(e < tol, f"phase 15b {dtype}: {n} gradient {e} of scale "
                  f"against the plain forward's")
            e_grad = max(e_grad, e)
        worst[dtype] = dict(loss=e_loss, grad=e_grad, lse=rec.lse_err,
                            abs=rec.abs["flash_attention_bh"])
        print(f"phase 15b: {cfg.name} widths at {GRAD_LAYERS} layers "
              f"{dtype}, B{GRAD_BATCH} S{GRAD_SEQ}: loss {float(loss_k):.6f} "
              f"against plain {float(loss_p):.6f}; {live} of {len(g_p)} "
              f"gradients live, each within {e_grad:.3g} of scale of the "
              f"plain forward's (< {tol}); {rec.lse_calls} kernel calls "
              f"with lse, out within {rec.err['flash_attention_bh']:.3g}, "
              f"lse within {rec.lse_err:.3g} of scale of plain (< {TOL}) "
              f"[{card}]", flush=True)
        del model, g_k, g_p
        torch.cuda.empty_cache()
    return worst


def reduced_train_run(model, batch, accum, captured):
    """REDUCED_STEPS steps on ``batch`` of a copy of ``model`` from fresh
    AdamW state, through the captured train program or the eager step:
    (losses, weights)."""
    import copy
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.steps import capture_train_step, make_train_step
    m = copy.deepcopy(model)
    opt = adamw_init(dict(m.named_parameters()))
    kw = dict(accum=accum, **TRAIN_SCHED)
    step = (capture_train_step(m, opt, batch, **kw) if captured
            else make_train_step(m, **kw))
    losses = []
    for _ in range(REDUCED_STEPS):
        opt, met = step(m, opt, batch)
        losses.append(float(met["loss"]))
    return losses, weights_of(m)


def phase_train_reduced(dev, card):
    """Phase 15c: the ten registry archs reduced, f32 on the card (TF32
    off) against the same weights and batch on the CPU: the loss and every
    gradient within TOL of scale (``accum`` 2 on ACCUM_ARCH), AdamW on the
    CPU's gradients within ADAMW_TOL of scale on both, and one
    ``make_train_step`` step each (every weight within ``2 lr (1 + 0.1
    |p|)`` of the CPU's: AdamW's sign sensitivity, see
    ``tests/test_torch_train.py``); then REDUCED_STEPS steps through the
    captured train program against as many eager steps, losses and
    weights held by :func:`hold_runs`."""
    import copy
    import torch
    from repro_torch.configs.registry import ARCH_IDS, get_config
    from repro_torch.models.transformer import Model
    from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
    from repro_torch.runtime.steps import loss_and_grads, make_train_step

    worst = {"loss": 0.0, "grad": 0.0, "adamw": 0.0, "step": 0.0}
    held = {}
    lr = cosine_schedule(0, **TRAIN_SCHED)
    for i, arch in enumerate(ARCH_IDS):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32")
        accum = 2 if arch == ACCUM_ARCH else 1
        cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(i))
        model = copy.deepcopy(cpu).to(dev)
        batch = lm_batch(cfg, REDUCED_BATCH, REDUCED_SEQ, i, dev)
        batch["labels"] = batch["tokens"]
        cbatch = {k: v.cpu() for k, v in batch.items()}
        for m in (cpu, model):
            m.requires_grad_(True)
        l_c, g_c = loss_and_grads(cpu, cbatch, accum=accum)
        zero_counts()
        l_k, g_k = loss_and_grads(model, batch, accum=accum)
        torch.cuda.synchronize()
        check_counts(f"phase 15c {arch}", read_counts(),
                     {"flash_attention_bh": train_flash_launches(cfg, accum)})
        e_loss = abs(float(l_k) - float(l_c)) / max(1.0, abs(float(l_c)))
        e_grad = max(rel_err(g_k[n].cpu(), g) for n, g in g_c.items())
        check(e_loss < TOL and e_grad < TOL, f"phase 15c {arch}: loss "
              f"{e_loss}, gradients {e_grad} of scale against the CPU")
        pc = {n: p.detach().clone() for n, p in cpu.named_parameters()}
        pk = {n: p.to(dev) for n, p in pc.items()}
        adamw_update(g_c, adamw_init(pc), pc, lr)
        adamw_update({n: g.to(dev) for n, g in g_c.items()},
                     adamw_init(pk), pk, lr.to(dev))
        e_ada = max(rel_err(pk[n].cpu(), pc[n]) for n in pc)
        check(e_ada < ADAMW_TOL, f"phase 15c {arch}: AdamW on the same "
              f"gradients {e_ada} of scale apart")
        steps = [make_train_step(m, accum=accum, **TRAIN_SCHED)
                 for m in (cpu, model)]
        steps[0](cpu, adamw_init(dict(cpu.named_parameters())), cbatch)
        steps[1](model, adamw_init(dict(model.named_parameters())), batch)
        e_step = 0.0
        for (n, a), (_, b) in zip(cpu.named_parameters(),
                                  model.named_parameters()):
            d = (b.detach().cpu() - a.detach()).abs()
            bound = 2 * float(lr) * (1 + 0.1 * a.detach().abs()) + 1e-6
            check(bool((d <= bound).all()), f"phase 15c {arch}: {n} moved "
                  f"{float((d - bound).max())} past the step bound")
            e_step = max(e_step, float(d.max()))
        for key, e in (("loss", e_loss), ("grad", e_grad), ("adamw", e_ada),
                       ("step", e_step)):
            worst[key] = max(worst[key], e)
        held[arch] = hold_runs(
            f"phase 15c {arch}", reduced_train_run(model, batch, accum, True),
            reduced_train_run(model, batch, accum, False),
            lambda: reduced_train_run(model, batch, accum, False))
        del cpu, model
    print(f"phase 15c: {len(ARCH_IDS)} reduced archs f32, B{REDUCED_BATCH} "
          f"S{REDUCED_SEQ} ({ACCUM_ARCH} with accum 2), card against CPU: "
          f"loss {worst['loss']:.3g}, gradients {worst['grad']:.3g} of "
          f"scale (< {TOL}); AdamW on the same gradients "
          f"{worst['adamw']:.3g} (< {ADAMW_TOL}); one full step's weights "
          f"apart by at most {worst['step']:.3g} (lr {float(lr)}) [{card}]",
          flush=True)
    n_bit = sum(h == "bit-equal" for h in held.values())
    print(f"phase 15c: {REDUCED_STEPS} steps through the captured train "
          f"program against {REDUCED_STEPS} eager steps, losses and "
          f"weights: {n_bit} of {len(held)} archs bit-equal"
          + "".join(f"; {a} {h}" for a, h in held.items()
                    if h != "bit-equal") + f" [{card}]", flush=True)
    return worst


def eager_train(cfg, dev, steps, batch, seq):
    """``train.main``'s run with the eager step in place of its program:
    the same weights (a generator seeded 0), batches
    (``SyntheticLMDataset(seed=0)``) and schedule.  Returns (losses, step
    walls in ms, the model)."""
    import torch
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models.transformer import Model
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.steps import make_train_step
    model = Model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=seq,
                            global_batch=batch, seed=0)
    step = make_train_step(model, total=steps, warmup=max(1, steps // 10))
    opt = adamw_init(dict(model.named_parameters()))
    losses, walls = [], []
    for _, b in zip(range(steps), ds):
        b = {k: torch.from_numpy(v).long().to(dev) for k, v in b.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt, m = step(model, opt, b)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    return losses, walls, model


def weights_of(model) -> dict:
    return {n: p.detach() for n, p in model.named_parameters()}


def hold_runs(what, captured, eager, again):
    """Hold a captured run (losses, weights) to an eager run from the same
    start: bit-equal, or, where a second eager run (``again()``, made only
    then) is not bit-equal to the first, within twice their spread (the
    largest difference of a loss and of a weight).  Returns a text."""
    def apart(a, b):
        dl = max(abs(x - y) for x, y in zip(a[0], b[0]))
        dw = max(float((a[1][n].float() - b[1][n].float()).abs().max())
                 for n in a[1])
        return dl, dw
    d = apart(captured, eager)
    if d == (0.0, 0.0):
        return "bit-equal"
    spread_ = apart(again(), eager)
    check(spread_ != (0.0, 0.0) and d[0] <= 2 * spread_[0]
          and d[1] <= 2 * spread_[1],
          f"{what}: the captured run is {d} (loss, weight) from the eager "
          f"one, two eager runs {spread_} apart")
    return (f"within the spread of two eager runs: loss {d[0]:.3g} and "
            f"weight {d[1]:.3g} from the eager run, two eager runs "
            f"{spread_[0]:.3g} and {spread_[1]:.3g} apart")


def phase_train(dev, errs, card):
    """Phase 15: the LM training path.  (a) olmo-1b at full width in bf16
    through ``repro_torch.launch.train.main``, every step one replay of
    the captured train step, then the same run with the eager step: losses
    and weights held equal; (d) the walls and profiles of both; (b)
    gradients through the kernel forward against the plain forward; (c)
    the ten reduced archs' train step against the CPU, and captured
    against eager.  Returns the kernels line's train_* fields."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    argv = ["--arch", TRAIN_ARCH, "--full", "--steps", str(TRAIN_STEPS),
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)]
    zero_counts()
    t0 = time.perf_counter()
    res = train.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = read_counts()
    cfg = res.model.cfg
    check(dataclasses.asdict(cfg) == dataclasses.asdict(
        get_config(TRAIN_ARCH)) and cfg.dtype == "bfloat16",
        f"phase 15a: not {TRAIN_ARCH} at full width in bf16: {cfg}")
    want = cfg.n_layers * 2 * TRAIN_STEPS
    check(want == train_flash_launches(cfg) * TRAIN_STEPS,
          "phase 15a: launches a step disagree with the layer count")
    check_counts("phase 15a train", counts, {"flash_attention_bh": want})
    check(res.program.program.graph is not None
          and res.program.program.calls == TRAIN_STEPS,
          "phase 15a: train.main's steps did not run through one captured "
          "program")
    check(all(math.isfinite(x) for x in res.losses),
          f"phase 15a: non-finite loss {res.losses}")
    check(res.losses[-1] < res.losses[0], f"phase 15a: the loss did not "
          f"fall: {res.losses}")
    print(f"phase 15a: train.main({' '.join(argv)}): {cfg.name} bf16, "
          f"{cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads, hd "
          f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, tied "
          f"{cfg.tie_embeddings}: {res.n_params} parameters made on the "
          f"card from seed 0; {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens in {run_s:.1f} s (weights included), every "
          f"step through one captured train program (its first call eager, "
          f"its second the capture); losses "
          + ", ".join(f"{x:.4f}" for x in res.losses) + "; lrs "
          + ", ".join(f"{x:.3g}" for x in res.lrs)
          + f"; launches {counts} through the program's counts [{card}]",
          flush=True)
    losses, eager_ms, emodel = eager_train(cfg, dev, TRAIN_STEPS,
                                           TRAIN_BATCH, TRAIN_SEQ)
    eager = (losses, weights_of(emodel))

    def again():
        a_losses, _, a_model = eager_train(cfg, dev, TRAIN_STEPS,
                                           TRAIN_BATCH, TRAIN_SEQ)
        return a_losses, weights_of(a_model)
    held = hold_runs("phase 15a", (res.losses, weights_of(res.model)),
                     eager, again)
    print(f"phase 15a: {TRAIN_STEPS} eager steps from the same seed: losses "
          + ", ".join(f"{x:.4f}" for x in losses) + f"; the captured run's "
          f"losses and weights {held} [{card}]", flush=True)
    del emodel, eager
    torch.cuda.empty_cache()
    fields = phase_train_walls(dev, res, eager_ms, card)
    del res
    torch.cuda.empty_cache()
    grads = phase_train_grads(dev, card)
    errs["flash_attention_bh"] = max(errs["flash_attention_bh"],
                                     *(g["abs"] for g in grads.values()))
    phase_train_reduced(dev, card)
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    return fields


# ---------------------------------------------------------------------------
# Phase 16: the LM planner and its dry run
# ---------------------------------------------------------------------------

#: the TPU v5e's constants, the reference's (peak bf16, HBM, link)
V5E = dict(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)
#: 16b: (name, arch, (seq, batch, mode)) counted on the one-card mesh and
#: run on the card under the same counter
#: run on the card with every step of the SSM time loops run; the ssm and
#: hybrid cases (depth cut to the last field: zamba2's 7 layers run its
#: shared attention block twice) are counted with the loops folded
DRY_CASES = (("olmo-1b train", TRAIN_ARCH, (TRAIN_SEQ, TRAIN_BATCH, "train"),
              None),
             ("llama3-8b decode", "llama3-8b", (LM_DECODE_KEYS, 4, "decode"),
              None),
             ("llama3-8b prefill", "llama3-8b", (LM_LONG, 1, "prefill"),
              None),
             ("rwkv6-3b train", "rwkv6-3b", (256, 2, "train"), 2),
             ("zamba2-1.2b train", "zamba2-1.2b", (256, 2, "train"), 7))
#: counted FLOPs against the analytic count (the matmuls and attention
#: exactly; the elementwise work, one FLOP an element, is the rest)
DRY_FLOPS_TOL = 0.05
DRY_WALL_REPS = 3
#: host calls timed a variant in 16b's hook-cost probe
HOOK_CALLS = 2000


def short_strategy(st) -> str:
    return (f"{st.attn}/{st.ffn}/{st.moe}"
            + ("/resident" if st.decode_resident else ""))


def phase_lm_planner(card):
    """Phase 16a: ``choose_strategy`` for every registry arch and mode on
    the H100 production mesh (16 x 16), beside the v5e constants'; the
    reference test's feasibility rules (``tests/test_shard_plan.py``) and
    every parameter and cache spec dividing its tensor."""
    from repro_torch.configs.registry import ARCH_IDS, get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.runtime.planner import choose_strategy
    from repro_torch.runtime.shard_plan import (_fits, cache_specs,
                                                param_specs, tree_leaves)

    mesh = make_production_mesh()
    m = mesh.shape["model"]
    differ = 0
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        model = Model(cfg, device="meta")
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        cache = model.cache_init(128, 4096)
        row = []
        for mode in ("train", "prefill", "decode"):
            st = choose_strategy(cfg, mesh, mode)
            v5 = choose_strategy(cfg, mesh, mode, **V5E)
            check(st.attn in ("tp", "sp") and st.ffn in ("tp", "sp"),
                  f"phase 16a: {arch} {mode}: {st}")
            if cfg.moe and cfg.moe.n_experts % m:
                check(st.moe == "tp", f"phase 16a: {arch} {mode}: experts "
                      f"do not divide {m} but moe {st.moe}")
            for n, spec in param_specs(model, mesh, st, mode).items():
                check(_fits(shapes[n], spec, mesh), f"phase 16a: {arch} "
                      f"{mode}: {n} {shapes[n]} under {spec}")
            for leaf, spec in zip(tree_leaves(cache), tree_leaves(
                    cache_specs(cache, mesh, st))):
                check(_fits(tuple(leaf.shape), spec, mesh),
                      f"phase 16a: {arch}: cache {tuple(leaf.shape)} under "
                      f"{spec}")
            differ += st != v5
            row.append(f"{mode} {short_strategy(st)}"
                       + ("" if st == v5 else
                          f" (v5e: {short_strategy(v5)})"))
        print(f"phase 16a: {arch} on 16x16, attn/ffn/moe: "
              + "; ".join(row), flush=True)
    print(f"phase 16a: 30 strategies, every spec divides; {differ} differ "
          f"from the v5e constants' (host only) [{card}]", flush=True)


def analytic_flops(cfg, seq, batch, mode) -> float:
    """FLOPs of one step of ``mode`` counted from the config alone:
    ``model_flops_estimate`` less its input-embedding term where the
    embeddings are untied (a lookup does no FLOPs), plus the attention
    (the flash kernel's masked pairs a call; decode at the cache's last
    position, every key live) and in training the remat recompute of the
    blocks and the plain flash backward (five [S, S] products a head).
    The non-reentrant checkpoint stops its recompute at the last tensor
    the backward saved, so a dense block's down projection, whose output
    nothing saves, is not recomputed."""
    from repro_torch.launch.op_cost import attention_pairs
    from repro_torch.launch.roofline import model_flops_estimate
    mf = model_flops_estimate(cfg, seq, batch, mode)
    tokens = batch * (seq if mode != "decode" else 1)
    mult = 6.0 if mode == "train" else 2.0
    emb = cfg.vocab * cfg.d_model
    if not cfg.tie_embeddings:
        mf -= mult * emb * tokens
    H, hd, L = cfg.n_heads, cfg.hd, cfg.n_layers
    if mode == "decode":
        return mf + 4.0 * batch * H * seq * hd * L
    fwd = 4.0 * batch * H * attention_pairs(seq, True,
                                            cfg.attn_window) * hd * L
    if mode == "prefill":
        return mf + fwd
    recomputed = mf / (mult * tokens) - emb - L * cfg.d_model * cfg.d_ff
    return (mf + 2.0 * recomputed * tokens + 2 * fwd
            + 10.0 * batch * H * seq * seq * hd * L)


def hook_costs(dev):
    """Host us a call of the paged decode wrapper at a small shape: called
    as the port calls it (the counter hook: one look at the dispatch-mode
    stack), through a ``torch.library.custom_op`` with ``register_fake``
    wrapping it (the idiomatic route the hook was weighed against), and
    the hook's look alone."""
    import importlib
    import torch
    from repro_torch.launch import op_cost
    fa = importlib.import_module("repro_torch.kernels.flash_attention")

    @torch.library.custom_op("repro_smoke::decode", mutates_args=())
    def probe(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
              table: torch.Tensor, kv_len: int, groups: int) -> torch.Tensor:
        return fa.flash_decode_paged(q, kp, vp, table, kv_len,
                                     groups=groups)

    @probe.register_fake
    def _(q, kp, vp, table, kv_len, groups):
        return torch.empty_like(q)

    g = torch.Generator(device=dev).manual_seed(16)
    q = torch.randn((32, 128), generator=g, device=dev).to(torch.bfloat16)
    kp, vp = (torch.randn((8, 2, 16, 128), generator=g, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    table = torch.arange(2, dtype=torch.int32, device=dev)
    out = {}
    for name, fn in (("hook", lambda: fa.flash_decode_paged(
            q, kp, vp, table, 32, groups=4)),
            ("custom_op", lambda: probe(q, kp, vp, table, 32, 4))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOOK_CALLS):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / HOOK_CALLS * 1e6
    t0 = time.perf_counter()
    for _ in range(HOOK_CALLS * 10):
        op_cost.active()
    out["look"] = (time.perf_counter() - t0) / (HOOK_CALLS * 10) * 1e6
    return out


def flash_at(dev, cfg, batch, seq, name) -> None:
    """``flash_attention_bh`` at a model's self-attention shape (``batch``
    x ``seq`` tokens) on random inputs, held against its plain version at
    the reference's tolerance for the config's dtype."""
    import importlib
    import torch
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    dt = getattr(torch, cfg.dtype)
    g = torch.Generator(device=dev).manual_seed(17)
    q = torch.randn((batch, cfg.n_heads, seq, cfg.hd), generator=g,
                    device=dev).to(dt)
    k, v = (torch.randn((batch, cfg.n_kv, seq, cfg.hd), generator=g,
                        device=dev).to(dt) for _ in range(2))
    got = fa.attention(q, k, v, causal=True, window=cfg.attn_window,
                       scale=None)
    want = plain_attention(q.float(), k.float(), v.float(), True,
                           cfg.attn_window)
    e = rel_err(got, want)
    tol = 2e-2 if dt == torch.bfloat16 else TOL
    check(e < tol, f"phase 16b {name}: flash_attention_bh at "
          f"{tuple(q.shape)} off its plain version by {e:.3e} of scale")
    print(f"phase 16b: {name}: flash_attention_bh at the step's shape "
          f"{tuple(q.shape)} {cfg.dtype} within {e:.3e} of scale of its "
          f"plain version", flush=True)


def phase_dryrun_live(dev, card):
    """Phase 16b: each DRY_CASES step counted by the dry run on the
    one-card mesh (fake tensors), then built on real weights on the card
    and run once under the same counter: FLOPs, bytes and kernel units
    equal; launches (the wrappers' counters, zeroed just before) equal to
    the config's; argument bytes equal to the live tensors'; the counted
    FLOPs within DRY_FLOPS_TOL of :func:`analytic_flops`; every warm wall,
    timed without the counter, at or above the roofline's max(t_compute,
    t_memory).  Returns the launches by kernel."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.runtime.shard_plan import Strategy, tree_leaves

    mesh = make_local_mesh()
    check(mesh.shape == {"data": 1, "model": 1},
          f"phase 16b: the local mesh is {mesh.shape}, not one card")
    total = {"flash_attention_bh": 0, "flash_decode_paged": 0}
    model = None
    for name, arch, shape, layers in DRY_CASES:
        seq, batch, mode = shape
        cfg = get_config(arch)
        cut = None
        if layers is not None:
            def cut(c, _n=layers):
                return dataclasses.replace(c, n_layers=_n)
            cfg = cut(cfg)
        loops = cfg.family in ("ssm", "hybrid")
        t0 = time.perf_counter()
        rec = dryrun.run_one(arch, shape, mesh=mesh, cfg_transform=cut,
                             verbose=False)
        fake_s = time.perf_counter() - t0
        if model is None or model.cfg.name != cfg.name:
            del model
            torch.cuda.empty_cache()
            model = Model(cfg, device=dev).init(
                torch.Generator(device=dev).manual_seed(16))
        kname = "flash_decode_paged" if mode == "decode" \
            else "flash_attention_bh"
        want = train_flash_launches(cfg) if mode == "train" \
            else cfg.n_layers
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        counter, inputs, _, _ = dryrun.count_step(
            cfg, model, shape, mesh, Strategy(**rec["strategy"]),
            fold_loops=False)
        torch.cuda.synchronize()
        live_s = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() - base
        check_counts(f"phase 16b {name}", counts, {kname: want})
        total[kname] += counts[kname]
        if want and loops:
            flash_at(dev, cfg, batch, seq, name)
        if (counter.flops, counter.bytes) != (rec["hlo_flops"],
                                              rec["hlo_bytes"]):
            fake = {}
            from torch._subclasses.fake_tensor import FakeTensorMode
            with FakeTensorMode():
                fmodel = Model(cfg, device=dev)
                fc, _, _, _ = dryrun.count_step(
                    cfg, fmodel, shape, mesh, Strategy(**rec["strategy"]))
                fake = fc.by_op
            diff = {k: (counter.by_op.get(k), fake.get(k))
                    for k in set(counter.by_op) | set(fake)
                    if counter.by_op.get(k) != fake.get(k)}
            raise SmokeFailure(
                f"phase 16b {name}: live counts {counter.flops} FLOPs "
                f"{counter.bytes} bytes != fake {rec['hlo_flops']} / "
                f"{rec['hlo_bytes']}; ops that differ (live, fake): {diff}")
        want_units = {kname: want} if want else {}
        check(counter.units == rec["kernel_units"] == want_units,
              f"phase 16b {name}: units {counter.units} live, "
              f"{rec['kernel_units']} fake, {want_units} expected")
        live_args = sum(t.numel() * t.element_size() for t in {
            t.untyped_storage().data_ptr(): t
            for t in tree_leaves(inputs.args)}.values())
        # the allocator's peak less the arguments the step made (optimizer
        # state, cache, batch): the live intermediates
        peak -= live_args - sum(p.numel() * p.element_size()
                                for p in model.parameters())
        args = rec["mem_per_device"]["argument_size_bytes"]
        check(live_args == args, f"phase 16b {name}: argument bytes "
              f"{args} counted, {live_args} live")
        if loops:
            ana_text = ("no count from the config (the recurrences' "
                        "elementwise work is most of it)")
        else:
            ana = analytic_flops(cfg, seq, batch, mode)
            e = abs(counter.flops - ana) / ana
            check(e < DRY_FLOPS_TOL, f"phase 16b {name}: counted FLOPs "
                  f"{counter.flops} against {ana} analytic, {e:.3%}")
            ana_text = (f"FLOPs {(counter.flops - ana) / ana:+.3%} of the "
                        f"analytic {ana:.6g}")
        runs = {"eager": inputs.step}
        prog = step_program(model, inputs, batch, mode)
        if prog is not None:
            runs["replayed"] = prog
            prog()
            prog()          # the program's warm-up, then its capture
        walls = walls_in_turns(runs, DRY_WALL_REPS)
        roof = max(rec["t_compute_s"], rec["t_memory_s"]) * 1e3
        for kind, w in walls.items():
            check(min(w) >= roof, f"phase 16b {name}: a warm {kind} wall "
                  f"{min(w):.3f} ms below the roofline {roof:.3f} ms")
        med = spread(walls["eager"])[0]
        print(f"phase 16b: {name} ({arch} {cfg.dtype} {mode}, "
              f"{cfg.n_layers} layers, B {batch}, "
              f"{'capacity' if mode == 'decode' else 'S'} {seq}; strategy "
              f"{short_strategy(Strategy(**rec['strategy']))} on 1x1): "
              f"counted {rec['hlo_flops']:.6g} FLOPs, {rec['hlo_bytes']:.6g} "
              f"bytes, {rec['kernel_units']} in {fake_s:.1f} s on fake "
              f"tensors{' (time loops folded)' if loops else ''}; the live "
              f"run under the counter equal ({live_s:.1f} s, {counter.ops} "
              f"ops{', every loop step run' if loops else ''}), launches "
              f"{counts}; {ana_text}; arguments {args} bytes = the live "
              f"tensors'; "
              f"temp {rec['mem_per_device']['temp_size_bytes'] / 2**30:.3f} "
              f"GiB counted, {counter.peak_bytes / 2**30:.3f} live, the "
              f"allocator's peak over the arguments {peak / 2**30:.3f} GiB; "
              f"roofline {roof:.3f} ms ({rec['bottleneck']}: compute "
              f"{rec['t_compute_s'] * 1e3:.3f}, memory "
              f"{rec['t_memory_s'] * 1e3:.3f}); warm walls in turns: "
              f"{step_walls_text(walls, roof)}" + (
                  f"; eager over replayed "
                  f"{med / spread(walls['replayed'])[0]:.2f}x"
                  if "replayed" in walls else
                  " (a prefill has no captured program)")
              + f" [{card}]", flush=True)
        del inputs, counter, prog, runs
        if mode == "decode":
            costs = hook_costs(dev)
            print(f"phase 16b: host us a call of flash_decode_paged at 32 "
                  f"keys ({HOOK_CALLS} calls): through the wrapper with its "
                  f"counter hook {costs['hook']:.2f}, through a "
                  f"torch.library.custom_op {costs['custom_op']:.2f} "
                  f"(+{costs['custom_op'] - costs['hook']:.2f}); the hook's "
                  f"look at the mode stack alone {costs['look']:.3f} "
                  f"[{card}]", flush=True)
    del model
    torch.cuda.empty_cache()
    return total


def step_program(model, inputs, batch, mode):
    """The step of a dry-run case as its captured program, a callable of
    no arguments: the train step on the case's optimizer state and batch
    (``capture_train_step`` with ``make_train_step``'s defaults, as the
    dry run builds it), or the decode step at the cache's last position;
    None for a prefill."""
    from repro_torch.runtime.steps import (capture_decode_step,
                                           capture_train_step)
    args = inputs.args
    if mode == "train":
        prog = capture_train_step(model, args["opt"], args["batch"])
        return lambda: prog(model, args["opt"], args["batch"])
    if mode == "decode":
        cache, tok = args["cache"], args["tokens"]
        last = inputs.meta["capacity"] - 1
        prog = capture_decode_step(model, cache, batch)
        return lambda: prog(cache, tok, last)
    return None


def phase_dryrun_production(card):
    """Phase 16c: the production dry runs through the launchers, each
    record under ``tests/test_dryrun.py``'s assertions, and both report
    tables."""
    from repro_torch.launch import report, serve, train

    recs = serve.main(["--arch", "llama3-8b", "--dry-run", "--shape",
                       "decode_32k"])
    recs += train.main(["--arch", TRAIN_ARCH, "--dry-run"])
    for r in recs:
        what = f"phase 16c: {r['arch']} {r['shape']}"
        check(r["hlo_flops"] > 0 and r["hlo_bytes"] > 0, what)
        check(r["bottleneck"] in ("compute", "memory", "collective"), what)
        check(0 < r["useful_ratio"] < 10, f"{what}: useful ratio "
              f"{r['useful_ratio']}")
        check(r["mem_per_device"]["temp_size_bytes"] is not None, what)
        check(r["mesh"] == "16x16" and r["chips"] == 256, what)
    check(recs[0]["bottleneck"] == "memory", "phase 16c: the decode step "
          f"is {recs[0]['bottleneck']}-bound, not memory-bound")
    print(f"phase 16c: dry runs of the H100 production mesh (16x16, "
          f"{recs[0]['chips']} cards), per card [{card}]:\n"
          + report.dryrun_table(recs) + "\n" + report.roofline_table(recs),
          flush=True)


def phase_lm_dryrun(dev, card):
    """Phase 16: the LM planner (16a), the dry run held against live steps
    on the card (16b), the production dry runs (16c).  Returns the kernels
    line's dryrun_launches."""
    import torch
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    phase_lm_planner(card)
    total = phase_dryrun_live(dev, card)
    phase_dryrun_production(card)
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    return {k: {"dryrun_launches": v} for k, v in total.items()}


# ---------------------------------------------------------------------------
# Phase 17: the example scripts
# ---------------------------------------------------------------------------

#: (script, flags, its headline's marker)
EXAMPLES = (
    ("examples/torch_quickstart.py", (), "whole mobilenet"),
    ("examples/torch_plan_edge_cnn.py", ("--samples", "2000", "--trees",
                                         "20"), "worst gap"),
    ("examples/torch_serve_llm.py", ("--arch", "llama3-8b", "--batch", "4",
                                     "--prompt-len", "12", "--gen", "24"),
     "decode:"),
    ("examples/torch_train_lm.py", ("--steps", "80", "--ckpt",
                                    "build/phase17_lm.npz"), "final loss"),
)
HILLCLIMB = "experiments/torch_hillclimb.py"
#: the subprocess that runs one script as ``__main__`` with every kernel
#: wrapper it reaches replaced by a stand-in (``holding_recorders``,
#: ``LMRecorder``) that calls the wrapper and holds the call against its
#: plain version on the same inputs; it reports the launch counters,
#: zeroed just before the script, the held calls and their errors
SCRIPT_RUNNER = r"""
import json, runpy, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
import torch
from repro_torch.runtime import engine
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
sys.argv = sys.argv[2:]
held = {"conv2d_shard": 0, "matmul_tiled": 0}
errs = {"conv2d_shard": 0.0, "matmul_tiled": 0.0}
shapes = set()
engine.conv2d_shard, engine.matmul_tiled = cs.holding_recorders(
    held, errs, shapes)
lm = cs.LMRecorder()
cs.zero_counts()
code = 0
with lm:
    try:
        runpy.run_path(sys.argv[0], run_name="__main__")
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (0 if e.code is None
                                                        else 1)
launches = cs.read_counts()
held.update(lm.calls)
errs.update(lm.abs)
print("PHASE17 " + json.dumps({
    "launches": launches, "held": held, "errs": errs,
    "decode_routes": cs.decode_routes(),
    "shapes": sorted(str(s) for s in shapes | lm.shapes)}))
sys.exit(code)
"""


def load_script(path):
    """A script of the checkout as a module (its ``main`` not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(Path(path).stem,
                                                  ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_launches(script, flags) -> dict:
    """The kernel launches of one example at ``flags``, from its plans and
    configs (independent of the counters): the quickstart runs the local
    executor over its two MobileNet plans, each once and eager
    (``kernel_records``); the serving example decodes every prompt and
    generated position through ``flash_decode_paged`` in each layer and
    prefills the prompt once through ``flash_attention_bh``; the training
    example runs ``train_flash_launches`` a step."""
    import argparse
    name = Path(script).stem
    if name == "torch_quickstart":
        from repro_torch.configs.edge_models import mobilenet_v1
        from repro_torch.core import AnalyticEstimator, Testbed, chain
        from repro_torch.core.dpp import plan_search
        est, tb = AnalyticEstimator(), Testbed(nodes=4, bandwidth_gbps=1.0)
        conv = fc = 0
        for g in (chain("mb_prefix", mobilenet_v1(width=56).layers[:9]),
                  mobilenet_v1(width=56)):
            c, f = kernel_records(g, plan_search(g, est, tb).plan, tb.nodes)
            conv, fc = conv + c, fc + f
        return {"conv2d_shard": conv, "matmul_tiled": fc}
    if name == "torch_serve_llm":
        from repro_torch.configs.registry import get_config
        ap = argparse.ArgumentParser()
        for flag in ("--arch", "--batch", "--prompt-len", "--gen"):
            ap.add_argument(flag)
        a, _ = ap.parse_known_args(flags)
        n = get_config(a.arch).reduced().n_layers
        return {"flash_decode_paged": n * (int(a.prompt_len) + int(a.gen)),
                "flash_attention_bh": n}
    if name == "torch_train_lm":
        from repro_torch.configs.base import ModelConfig
        ap = argparse.ArgumentParser()
        ap.add_argument("--steps")
        a, _ = ap.parse_known_args(flags)
        cfg = ModelConfig(**load_script(script).CONFIG)
        return {"flash_attention_bh":
                train_flash_launches(cfg) * int(a.steps)}
    return {}


def example_decode_routes(script, flags, launches) -> dict:
    """The routes of an example's ``launches`` decode calls: the serving
    example's arch has several query heads a KV head in its reduced config
    (the grouped route on every call) or one (the per-row route)."""
    grouped = 0
    if Path(script).stem == "torch_serve_llm":
        import argparse
        from repro_torch.configs.registry import get_config
        ap = argparse.ArgumentParser()
        ap.add_argument("--arch")
        a, _ = ap.parse_known_args(flags)
        cfg = get_config(a.arch).reduced()
        grouped = launches if cfg.n_heads > cfg.n_kv else 0
    return {"per_row": launches - grouped, "grouped": grouped}


def example_held(script, flags) -> dict:
    """The LM kernels' calls an example makes eagerly (what LMRecorder
    holds): the serving example's decode program's first call (a layer
    each) and its fused prefill; the training example's program's first
    step.  The rest run inside the programs' graphs."""
    name = Path(script).stem
    launches = example_launches(script, flags)
    if name == "torch_serve_llm":
        return {"flash_decode_paged": launches["flash_attention_bh"],
                "flash_attention_bh": launches["flash_attention_bh"]}
    if name == "torch_train_lm":
        from repro_torch.configs.base import ModelConfig
        cfg = ModelConfig(**load_script(script).CONFIG)
        return {"flash_attention_bh": train_flash_launches(cfg)}
    return {"flash_attention_bh": 0, "flash_decode_paged": 0}


def hillclimb_checks(recs, card) -> None:
    """Every row of every pair counted; pair A's chunked rows below the
    recurrent ones in bytes; pair C's ep rows apart from its tp rows in
    collective bytes and below them in collective time (the reference's
    order), each ep row with an all-to-all; no row of pair B with one (its
    experts do not divide the model axis)."""
    from repro_torch.runtime.shard_plan import Strategy
    hc = load_script(HILLCLIMB)
    for pair, rows in hc.EXPERIMENTS.items():
        got = [r["label"] for r in recs[pair]]
        check(got == [r[2] for r in rows], f"phase 17: hillclimb {pair} "
              f"counted {got}, not every row")
    a = {r["label"]: r for r in recs["A"]}
    for label, r in a.items():
        base = "zamba2 baseline recurrent" if label.startswith("zamba2") \
            else "baseline recurrent scan"
        if "chunked" in label:
            check(r["hlo_bytes"] < a[base]["hlo_bytes"], f"phase 17: "
                  f"pair A {label} counts {r['hlo_bytes']:.6g} bytes, not "
                  f"below {base}'s {a[base]['hlo_bytes']:.6g}")
    c = recs["C"]
    ep = [r for r in c if r["strategy"]["moe"] == "ep"]
    tp = [r for r in c if r["strategy"]["moe"] == "tp"]
    check(ep and tp, "phase 17: pair C has no ep or no tp row")
    for e in ep:
        check("all-to-all" in e["coll_bytes"], f"phase 17: pair C "
              f"{e['label']}: no all-to-all")
        for t in tp:
            check(e["coll_bytes"] != t["coll_bytes"], f"phase 17: pair C "
                  f"{e['label']} and {t['label']} move the same bytes")
            check(t["t_collective_s"] > e["t_collective_s"], f"phase 17: "
                  f"pair C {t['label']} below {e['label']} in collective "
                  f"time, the reference's reverse")
    for r in recs["B"]:
        check("all-to-all" not in r["coll_bytes"], f"phase 17: pair B "
              f"{r['label']} has an all-to-all")
    for pair in ("A", "B", "C", "D"):
        for r in recs[pair]:
            kinds = ", ".join(f"{k} {v:.4g}"
                              for k, v in sorted(r["coll_bytes"].items()))
            print(f"phase 17: hillclimb {pair} {r['label']:32s} "
                  f"{short_strategy(Strategy(**r['strategy']))} "
                  f"flops {r['hlo_flops']:.4g} bytes {r['hlo_bytes']:.4g} "
                  f"coll {sum(r['coll_bytes'].values()):.4g} ({kinds}) "
                  f"t_coll {r['t_collective_s']:.4g} s, "
                  f"{r['bottleneck']}-bound [{card}]", flush=True)


def phase_scripts(errs, card) -> dict:
    """Phase 17: the four examples on the card, one subprocess each at
    reduced flags (exit 0, the headline printed, each kernel's launches
    equal to the count its plans and config give, every eager call held
    against its plain version, the largest differences kept in
    ``errs``), while the hillclimb's four pairs run beside them, one
    subprocess a pair, counted on fake CUDA tensors.  Returns the
    launches by kernel, summed over the examples."""
    import os
    import shutil
    t_phase = time.perf_counter()
    out_dir = ROOT / "experiments" / "torch_hillclimb"
    shutil.rmtree(out_dir, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    climbs = {pair: subprocess.Popen(
        [sys.executable, str(ROOT / HILLCLIMB), pair], cwd=str(ROOT),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pair in ("A", "B", "C", "D")}
    total = {name: 0 for name in kernel_wrappers()}
    try:
        for script, flags, marker in EXAMPLES:
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-c", SCRIPT_RUNNER, str(ROOT),
                 str(ROOT / script), *flags], cwd=str(ROOT), env=env,
                capture_output=True, text=True, timeout=600)
            secs = time.perf_counter() - t0
            check(res.returncode == 0, f"phase 17: {script} exited "
                  f"{res.returncode}:\n{res.stdout[-2000:]}\n"
                  f"{res.stderr[-3000:]}")
            lines = res.stdout.splitlines()
            got = json.loads(next(ln for ln in lines
                                  if ln.startswith("PHASE17 "))
                             .split(" ", 1)[1])
            launches, held = got["launches"], got["held"]
            want = example_launches(script, flags)
            check_counts(f"phase 17: {script}", launches, want)
            routes = example_decode_routes(script, flags,
                                           launches["flash_decode_paged"])
            check(got["decode_routes"] == routes, f"phase 17: {script}: "
                  f"flash_decode_paged by route {got['decode_routes']} != "
                  f"{routes}")
            # a captured program's replays (a segment's, an LM step's)
            # launch without a call; its first call, eager, was held
            want_held = example_held(script, flags)
            check(all((held[k] > 0) == (n > 0) and held[k] <= n
                      for k, n in launches.items())
                  and all(held[k] == n for k, n in want_held.items()),
                  f"phase 17: {script}: launches {launches}, calls held "
                  f"against plain {held}, the LM's eager calls "
                  f"{want_held}")
            for k, n in launches.items():
                total[k] += n
                if n:
                    errs[k] = max(errs[k], got["errs"][k])
            head = [ln.strip() for ln in lines if marker in ln]
            check(head, f"phase 17: {script} printed no {marker!r} line")
            print(f"phase 17: {script} {' '.join(flags)}: exit 0 in "
                  f"{secs:.1f} s; {' | '.join(head)}; launches "
                  f"{ {k: v for k, v in launches.items() if v} } as its "
                  f"plans and config give (decode by route "
                  f"{got['decode_routes']}); calls held against their "
                  f"plain versions {held} (TOL f32, BF16_TOL bf16; max abs "
                  f"{ {k: got['errs'][k] for k, v in launches.items() if v} })"
                  f" at {len(got['shapes'])} call shapes: "
                  f"{'; '.join(got['shapes'][:8])} [{card}]", flush=True)
        recs = {}
        for pair, proc in climbs.items():
            text, _ = proc.communicate(timeout=900)
            check(proc.returncode == 0 and "FAILED" not in text,
                  f"phase 17: hillclimb {pair} exited {proc.returncode}:"
                  f"\n{text[-3000:]}")
            recs[pair] = json.loads((out_dir / f"{pair}.json").read_text())
    finally:
        for proc in climbs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    hillclimb_checks(recs, card)
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s; launches "
          f"over the examples {total} [{card}]", flush=True)
    return total


def run(dev) -> dict:
    import torch
    from repro_torch import obs
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(f"phase 1: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"float32_matmul_precision="
          f"{torch.get_float32_matmul_precision()} "
          f"(plain versions in full f32)", flush=True)
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"phase 1: built {sorted(libs)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, path in sorted(libs.items()):
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}", flush=True)

    errs = {name: 0.0 for name in kernel_wrappers()}
    phase_kernel_grid(dev, errs)
    ulp = {}
    phase_kernel_grid_half(dev, ulp)

    totals = {"conv2d_shard": 0, "matmul_tiled": 0}
    rows = [phase_main_path(dev, name, kw, seed, totals, errs, card)
            for seed, (name, kw) in enumerate(MAIN_MODELS)]
    t4b = time.perf_counter()
    half = [phase_main_path_bf16(dev, row, ulp, card) for row in rows]
    print(f"phase 4b: the bf16 main path took "
          f"{time.perf_counter() - t4b:.1f} s", flush=True)
    phase_decode_grid(dev, errs)
    phase_decode_long(dev, errs, card)
    dec = phase_decode_path(dev, errs, card)
    totals["flash_decode_paged"] = dec["launches"]
    flash = phase_flash(dev, errs, card)
    totals["flash_attention_bh"] = len(flash)
    for kname, t in totals.items():
        check(t > 0, f"{kname} was never launched on the main path")
    for row in rows:
        phase_mesh(dev, row, errs, card)
    phase_mesh_decode(dev, dec, card)
    for row in rows:
        # MobileNet's loop with metrics on: phase 13c prints its gauges
        mx = obs.set_metrics(obs.Metrics()) \
            if row["model"] == "mobilenet" else None
        try:
            row["refine"] = phase_refine(dev, row, errs, card)
        finally:
            obs.set_metrics(None)
        if mx is not None:
            row["refine_metrics"] = mx.snapshot()
    phase_gbdt(dev, rows, errs, card)
    phase_observe(dev, rows, errs, card)
    lm = phase_lm(dev, errs, card)
    lm["flash_attention_bh"].update(phase_train(dev, errs, card))
    for kname, fields in phase_lm_dryrun(dev, card).items():
        lm[kname].update(fields)
    for kname, n in phase_scripts(errs, card).items():
        lm.setdefault(kname, {})["scripts_launches"] = n
    for r in rows:
        r.pop("mesh_inputs")

    meta = {
        "conv2d_shard": ("src/repro_torch/kernels/csrc/conv2d_shard.cu",
                         "src/repro/kernels/conv2d.py:99"),
        "matmul_tiled": ("src/repro_torch/kernels/csrc/matmul_tiled.cu",
                         "src/repro/kernels/ops.py:64"),
        "flash_decode_paged": (
            "src/repro_torch/kernels/csrc/flash_decode_paged.cu",
            "src/repro/kernels/flash_attention.py:127"),
        "flash_attention_bh": (
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:169"),
    }
    kernels = []
    for kname, (source, replaces) in meta.items():
        if kname == "flash_attention_bh":
            # per case: f32 and bf16 cases have different peak rates
            bm = sum(r["bound_ms"] for r in flash)
            by_ops = sum(r["bound_ms"] for r in flash
                         if r["bound_by"] == "operations")
            by = "operations" if by_ops >= bm / 2 else "bytes"
            rs = flash
        else:
            rs = [dec] if kname == "flash_decode_paged" else \
                [r[kname] for r in rows if kname in r]
            bm, by = bound_ms(sum(r["bytes"] for r in rs),
                              sum(r["flops"] for r in rs))
        if kname in ("conv2d_shard", "matmul_tiled"):
            hs = [h[kname] for h in half if kname in h]
            bm16, by16 = bound_ms(sum(r["bytes"] for r in hs),
                                  sum(r["flops"] for r in hs),
                                  PEAK_BF16_FLOPS)
            held = [v for (k, xd, _), v in ulp.items()
                    if k == kname and xd == "bfloat16"]
            lm.setdefault(kname, {}).update(
                bf16_ms=sum(r["ms"] for r in hs),
                bf16_launches=sum(h["launches"][kname] for h in half),
                bf16_plain_ms=sum(r["plain_ms"] for r in hs),
                bf16_library_ms=sum(r["library_ms"] for r in hs),
                bf16_bound_ms=bm16, bf16_bound_by=by16,
                bf16_max_ulp=max(v["max_ulp"] for v in held),
                bf16_past_one_ulp=sum(v["cancel"] for v in held),
                bf16_routes={r: sum(h["routes"][kname][r] for h in half)
                             for r in half[0]["routes"][kname]})
            if kname == "matmul_tiled":
                lm[kname]["bf16_shapes"] = [
                    s for h in half for s in h.get(kname, {}).get(
                        "shapes", [])]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": totals[kname],
            "max_abs_err": errs[kname],
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": bm, "bound_by": by,
            "library_ms": sum(r["library_ms"] for r in rs),
            **lm.get(kname, {}),
        })
    print("kernel times are per main-path pass on "
          f"{card}: conv2d_shard and matmul_tiled over mobilenet-224 + "
          "resnet18-224 + bert-base (one Session.run each), "
          "flash_decode_paged over one olmo-1b-width greedy_decode "
          f"({PROMPT_LEN} + {N_NEW} tokens; kv_len from device memory), "
          "flash_attention_bh over the "
          f"{len(FLASH_CASES)} ops.flash_attention cases; CUDA-graph "
          "replay; lm_* on the attention kernels: phase 14's llama3-8b "
          "bf16 serving pass (flash_decode_paged: the served decode's "
          f"{LM_SERVE[3]} x ({LM_SERVE[5]} + {LM_SERVE[7]}) tokens' "
          "calls, kv_len from 1, by route in lm_routes, "
          f"lm_{LM_DECODE_KEYS}_* one call at {LM_DECODE_KEYS} keys, "
          "lm_*shape the launch decode_shape picks; "
          "flash_attention_bh: one prefill forward of the served tokens "
          f"and one of 1 x {LM_LONG}); train_* on flash_attention_bh: "
          f"phase 15's {TRAIN_ARCH} bf16 step of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens (its calls with lse, graph replay) beside "
          "the plain flash backward and SDPA's forward with lse; "
          "dryrun_launches: phase 16b's live steps under the op counter; "
          "scripts_launches: phase 17's four examples; bf16_* on "
          "conv2d_shard and matmul_tiled: phase 4b's bf16 pass of the "
          "three models (graph replay; bound at 2-byte operands and the "
          "bf16 tensor-core peak), bf16_routes its launches by loop, "
          "bf16_shapes each FC shape's calls of it against cuBLAS in bf16 "
          "(graph replay), bf16_max_ulp and bf16_past_one_ulp "
          "over every bf16 call of phases 2 and 4b",
          flush=True)
    return {"kernels": kernels}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a "
              "GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    result = run(dev)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
