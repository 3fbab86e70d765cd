#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one CUDA card and the CUDA
toolkit.  It builds the hand-written kernels from ``src/repro_torch/
kernels/csrc``, holds each against its plain PyTorch version on the card,
then drives the port's main path — ``plan_search`` -> ``Session(...,
ExecConfig(backend="cuda")).run(x)`` — at full width on MobileNet v1
(224x224), ResNet-18 (224x224) and bert-base (seq 128, d 768, 12 layers)
with random weights from a fixed seed, and checks each output against the
unpartitioned reference and each ``ExecStats`` against the generic
``backend="torch"`` run.  The kernels' launch counters are zeroed just
before each model's run and must then equal the number of conv and FC
records the plan hands to the kernels.

Times are taken on the card: the warm ``Session.run`` wall time per model
(synchronised), and each kernel's device time over the calls one main-path
run makes, replayed as a CUDA graph so host launch overhead is left out,
beside the same calls through the plain version, through one PyTorch
library call (``F.conv2d`` after ``F.pad`` where the pads are asymmetric;
``torch.matmul``) and the least time the card could take (bytes over
3.35 TB/s or f32 flops over 67 TFLOP/s, whichever is larger).

Output: progress lines, the card's name and power limit from nvidia-smi, a
``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
that line.  Without a CUDA device, or outside a checkout, it exits
non-zero and prints no result.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-4                      # scale-normalised; f32 sums in other orders
PEAK_F32_FLOPS = 67e12          # H100 SXM, CUDA cores, f32 (data sheet)
PEAK_BYTES = 3.35e12            # H100 SXM HBM3 (data sheet)
NODES = 4
MAIN_MODELS = (("mobilenet", {}), ("resnet18", {}), ("bert", {}))
TIMED_REPS = 20


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


# ---------------------------------------------------------------------------
# Expected kernel records of a plan (independent of the launch counters)
# ---------------------------------------------------------------------------

def kernel_records(graph, plan, nodes):
    """(conv, fc) counts of the non-degenerate conv-family and FC records
    that the local executor hands to the kernels for ``plan``."""
    from repro_torch.core.graph import ConvT
    from repro_torch.core.plan import steps_segments
    from repro_torch.kernels.conv2d import shard_out_shape
    from repro_torch.runtime.engine import (_segment_records,
                                            backward_chain, exact_regions)

    counts = [0, 0]

    def branch(layers, steps):
        for a, b in steps_segments(steps):
            for cells in exact_regions(layers[b], steps[a][0], nodes):
                for reg in cells:
                    need, in_rect = backward_chain(layers, a, b, reg)
                    recs = _segment_records(layers, a, b, need, in_rect)
                    rows = in_rect[0][1] - in_rect[0][0]
                    for li, (t, k, s, pads, sl, chans) in zip(
                            range(a, b + 1), recs):
                        t = ConvT(t)
                        width = chans[1] - chans[0]
                        if t == ConvT.FC:
                            counts[1] += rows > 0 and width > 0
                        elif t in (ConvT.CONV, ConvT.POINTWISE,
                                   ConvT.DWCONV):
                            oh, ow = shard_out_shape(sl[1] - sl[0],
                                                     sl[3] - sl[2], k, s,
                                                     pads)
                            cout = width if t != ConvT.DWCONV else \
                                layers[li].in_c
                            counts[0] += oh > 0 and ow > 0 and cout > 0
                        rows = need[li][0][1] - need[li][0][0]

    layers = graph.layers
    if graph.is_chain:
        branch(layers, plan.steps)
        return tuple(counts)
    for br in graph.linearize():
        ids = list(br.ids)
        rest = ids[1:] if graph.fan_in(ids[0]) >= 2 else ids
        if rest:
            branch([layers[i] for i in rest], [plan.steps[i] for i in rest])
    return tuple(counts)


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


def conv_work(x, w, out, depthwise):
    """(bytes, flops) one conv shard call must move and do."""
    k = w.shape[0]
    ho, wo, cout = out.shape
    cin = x.shape[2]
    flops = 2.0 * ho * wo * cout * k * k * (1 if depthwise else cin)
    return 4.0 * (x.numel() + w.numel() + out.numel()), flops


def matmul_work(x, w, out):
    m, k = x.shape
    return 4.0 * (x.numel() + w.numel() + out.numel()), \
        2.0 * m * k * w.shape[1]


def bound_ms(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_kernel_grid(dev, errs):
    """Each kernel against its plain version on the card at the shapes of
    the edge models: every conv geometry at its first full-width layer x
    every shard pad signature (strided-view and contiguous inputs, and a
    channel-view weight), and the bert-base and classifier-head FC
    shapes (whole and column-sliced weights)."""
    import torch
    from repro_torch.configs.edge_models import EDGE_MODELS
    from repro_torch.core.graph import ConvT, shard_halo_pads
    from repro_torch.kernels.conv2d import conv2d_shard
    from repro_torch.kernels.ops import matmul_tiled
    from repro_torch.kernels.ref import conv2d_shard_ref, matmul_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    first = {}
    for name, f in EDGE_MODELS.items():
        for l in f().layers:
            if l.conv_t in (ConvT.CONV, ConvT.POINTWISE, ConvT.DWCONV):
                first.setdefault((l.conv_t, l.k, l.s, l.p), l)
    n = 0
    for (t, k, s, p), l in sorted(first.items()):
        dw = t == ConvT.DWCONV
        if dw:
            w = torch.randn((k, k, 1, l.in_c), generator=gen, device=dev)
        else:
            w = (torch.randn((k, k, l.in_c, l.out_c + 3), generator=gen,
                             device=dev)
                 / (k * k * l.in_c) ** 0.5)[..., 1:1 + l.out_c]
        for pads in shard_halo_pads(p):
            big = torch.randn((l.in_h + 2, l.in_w + 2, l.in_c + 1),
                              generator=gen, device=dev)
            view = big[1:1 + l.in_h, 2:2 + l.in_w, :l.in_c]
            for x in (view, view.contiguous()):
                out = conv2d_shard(x, w, pads=pads, stride=s, depthwise=dw)
                ref = conv2d_shard_ref(x, w, pads=pads, stride=s,
                                       depthwise=dw)
                torch.cuda.synchronize()
                e = rel_err(out, ref)
                check(e < TOL, f"conv2d_shard {t.name} k{k} s{s} p{p} "
                               f"pads={pads}: scale-normalised error {e}")
                errs["conv2d_shard"] = max(errs["conv2d_shard"],
                                           abs_err(out, ref))
                n += 1
    print(f"phase 2: conv2d_shard == plain on {n} full-width cases "
          f"({len(first)} geometries x pad signatures x 2 layouts); "
          f"max abs err {errs['conv2d_shard']:.3g}", flush=True)
    shapes = [(128, 768, 2304), (128, 2304, 768), (128, 768, 3072),
              (128, 3072, 768), (1, 1024, 1000), (1, 512, 1000),
              (1, 2048, 1000), (1, 200, 100)]
    n = 0
    for m, cin, cout in shapes:
        x = torch.randn((m, cin), generator=gen, device=dev)
        w = torch.randn((cin, cout), generator=gen, device=dev) / cin ** 0.5
        share = -(-cout // NODES)
        for wv in (w, w[:, share:2 * share]):
            out = matmul_tiled(x, wv)
            ref = matmul_ref(x, wv)
            torch.cuda.synchronize()
            e = rel_err(out, ref)
            check(e < TOL, f"matmul_tiled [{m},{cin}]@{tuple(wv.shape)}: "
                           f"scale-normalised error {e}")
            errs["matmul_tiled"] = max(errs["matmul_tiled"],
                                       abs_err(out, ref))
            n += 1
    print(f"phase 2: matmul_tiled == plain on {n} FC shapes; max abs err "
          f"{errs['matmul_tiled']:.3g}", flush=True)


def phase_main_path(dev, name, kw, seed, totals, errs, card):
    """plan_search -> Session(backend="cuda").run on one model at full
    width; returns the per-kernel timing row of this model."""
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
    sess_k = Session(g, ws, plan, NODES, ExecConfig(backend="cuda"))
    sess_t = Session(g, ws, plan, NODES, ExecConfig(backend="torch"))

    conv2d_shard.launches = 0
    matmul_tiled.launches = 0
    out_k, st_k = sess_k.run(x)
    torch.cuda.synchronize()
    got = (conv2d_shard.launches, matmul_tiled.launches)
    check(got == want, f"{name}: kernel launches {got} != the plan's "
                       f"kernel records {want}")
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
          f"matmul_tiled={got[1]} == plan records; err vs reference "
          f"{e_ref:.3g} (torch backend {e_t:.3g}); {st_k}", flush=True)

    # warm end-to-end wall time
    sess_k.run(x)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        sess_k.run(x)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    walls.sort()

    # record the kernel calls of one run, then time them three ways
    calls = {"conv2d_shard": [], "matmul_tiled": []}

    def rec_conv(xs, w, **kwargs):
        out = conv2d_shard(xs, w, **kwargs)
        calls["conv2d_shard"].append((xs, w, kwargs, out))
        return out

    def rec_mm(xs, w):
        out = matmul_tiled(xs, w)
        calls["matmul_tiled"].append((xs, w, out))
        return out

    engine.conv2d_shard, engine.matmul_tiled = rec_conv, rec_mm
    try:
        sess_k.run(x)
    finally:
        engine.conv2d_shard, engine.matmul_tiled = conv2d_shard, matmul_tiled
    torch.cuda.synchronize()

    row = {"model": name, "run_ms": walls[1]}
    conv_calls = calls["conv2d_shard"]
    mm_calls = calls["matmul_tiled"]
    for xs, w, kwargs, out in conv_calls:
        plain = conv2d_shard_ref(xs, w, **kwargs)
        check(rel_err(out, plain) < TOL, f"{name}: recorded conv call")
        errs["conv2d_shard"] = max(errs["conv2d_shard"], abs_err(out, plain))
    for xs, w, out in mm_calls:
        plain = matmul_ref(xs, w)
        check(rel_err(out, plain) < TOL, f"{name}: recorded FC call")
        errs["matmul_tiled"] = max(errs["matmul_tiled"], abs_err(out, plain))
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
    parts = [f"phase 4: {name}: warm Session.run {row['run_ms']:.3f} ms "
             f"(median of 3, synchronised)"]
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


def run(dev) -> dict:
    import torch
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

    errs = {"conv2d_shard": 0.0, "matmul_tiled": 0.0}
    phase_kernel_grid(dev, errs)

    totals = {"conv2d_shard": 0, "matmul_tiled": 0}
    rows = [phase_main_path(dev, name, kw, seed, totals, errs, card)
            for seed, (name, kw) in enumerate(MAIN_MODELS)]
    for kname, t in totals.items():
        check(t > 0, f"{kname} was never launched on the main path")

    meta = {
        "conv2d_shard": ("src/repro_torch/kernels/csrc/conv2d_shard.cu",
                         "src/repro/kernels/conv2d.py:99"),
        "matmul_tiled": ("src/repro_torch/kernels/csrc/matmul_tiled.cu",
                         "src/repro/kernels/ops.py:64"),
    }
    kernels = []
    for kname, (source, replaces) in meta.items():
        rs = [r[kname] for r in rows if kname in r]
        nbytes = sum(r["bytes"] for r in rs)
        flops = sum(r["flops"] for r in rs)
        bm, by = bound_ms(nbytes, flops)
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": totals[kname],
            "max_abs_err": errs[kname],
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": bm, "bound_by": by,
            "library_ms": sum(r["library_ms"] for r in rs),
        })
    print("kernel times are per main-path pass (mobilenet-224 + "
          "resnet18-224 + bert-base, one Session.run each, CUDA-graph "
          f"replay) on {card}", flush=True)
    return {"kernels": kernels}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a "
              "GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda")
    result = run(dev)
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
