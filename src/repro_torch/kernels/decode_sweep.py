"""Sweep of the paged decode kernel's grouped launch shape on the card.

    PYTHONPATH=src python -m repro_torch.kernels.decode_sweep

On a machine with a CUDA card and the toolkit.  At the LM's decode shapes
(a contiguous cache ``[B, KV, cap, hd]`` in bf16 read in place as pools,
as ``models.attention`` does): llama3-8b's served pass (B 4, 32 query
heads over 8 KV heads, hd 128, capacity 32, one call at each ``kv_len``
1..32), llama3-8b and qwen2-72b (64 over 8) at 4096 keys, it times the
grouped route (``flash_decode_paged(..., groups=G)``) at every split
count the table allows and every number of query rows a block
(:data:`~repro_torch.kernels.flash_attention.GROUP_ROWS`), with the waves
of clusters each takes, beside the shape
:func:`~repro_torch.kernels.flash_attention.decode_shape` picks, the
per-row route on the pools repeated ``G`` times (each query row's block
fetches its keys again, as every grouped call did before the grouped
route), one library call (the live keys and
``F.scaled_dot_product_attention`` with ``enable_gqa``) and the bytes
bound (the live K/V once, q, out and the live table entries over 3.35
TB/s).  Times are device time per call: the calls captured as one CUDA
graph and replayed between CUDA events; at 4096 keys the calls rotate
through enough cache copies that a replay reads more than the 50 MB L2.
Each case's calls are held against the library call first (2e-2 of
scale, bf16's tolerance).  Exits non-zero without a card.

    PYTHONPATH=src python -m repro_torch.kernels.decode_sweep --parent \
        trees/parent/src/repro_torch/kernels/csrc/flash_decode_paged.cu

also builds an earlier version of the kernel's source (one whose entry
points take no rows-a-block argument, as before the grouped route) and,
in the same process, holds the per-row route's outputs bit-equal to it
(the main path's f32 call and bf16 calls, every length, with and without
a window) and times both versions in turns (earlier, this, this,
earlier): the main path's call at 512 keys and the LM calls above, where
the earlier kernel reads a KV head once a query row.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib
import math
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from ..models.attention import page_size, page_table
from . import build

fa = importlib.import_module("repro_torch.kernels.flash_attention")

#: (label, batch, query heads, KV heads, hd, capacity, kv_len values)
CASES = (
    ("llama3-8b served", 4, 32, 8, 128, 32, tuple(range(1, 33))),
    ("llama3-8b 4096 keys", 4, 32, 8, 128, 4096, (4096,)),
    ("qwen2-72b 4096 keys", 4, 64, 8, 128, 4096, (4096,)),
)
SPLITS = (1, 2, 3, 4, 6, 8, 9, 12, 16)
#: bytes a replay of a long case reads at least (past the 50 MB L2)
ROTATE_BYTES = 160 * 2 ** 20
PEAK_BYTES = 3.35e12
REPS = 20
TOL = 2e-2


def replay_us(fn, calls: int) -> float:
    """Device microseconds per call of ``fn`` (which makes ``calls``
    calls), captured once as a CUDA graph and replayed ``REPS`` times."""
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


def live_bytes(rows, groups, hd, kv_len, ps) -> float:
    """Bytes one bf16 grouped call must move: each pool row's live K and V
    once, q and out, the live table entries."""
    return 2.0 * (2 * rows * kv_len * hd + 2 * rows * groups * hd) \
        + 4.0 * -(-kv_len // ps)


def forced(shape):
    """A ``decode_shape`` stand-in that returns ``shape`` for every call."""
    return lambda *_a: shape


def waves(rows, groups, hd, n_logical, ps, shape) -> float:
    """Waves of clusters a bf16 launch at ``shape`` takes: its clusters
    over the clusters the card holds at once (the occupancy entry)."""
    info = (ctypes.c_int * 4)()
    rc = build.load("flash_decode_paged").flash_decode_paged_occupancy_bf16(
        rows * groups, hd, 1, shape.splits, shape.warps, groups,
        shape.group_rows, n_logical, ps, info)
    if rc != 0:
        raise RuntimeError(f"flash_decode_paged_occupancy_bf16: {rc}")
    return rows * -(-groups // shape.group_rows) / info[2]


def sweep_case(dev, gen, label, B, H, KV, hd, cap, lens) -> None:
    groups, rows = H // KV, B * KV
    ps = page_size(cap)
    n_logical = cap // ps
    table = page_table(cap, dev)
    pair = 2 * B * KV * cap * hd * 2
    copies = max(1, -(-ROTATE_BYTES // pair)) if cap > 1024 else 1
    caches = [tuple(torch.randn((B, KV, cap, hd), generator=gen,
                                device=dev).bfloat16() for _ in range(2))
              for _ in range(copies)]
    pools = [tuple(t.view(rows, n_logical, ps, hd) for t in c)
             for c in caches]
    q = torch.randn((B * H, hd), generator=gen, device=dev).bfloat16()
    calls = copies * len(lens)

    def kern():
        return [fa.flash_decode_paged(q, kp, vp, table, n, groups=groups)
                for kp, vp in pools for n in lens]

    def library():
        return [F.scaled_dot_product_attention(
            q.view(B, H, 1, hd), k[:, :, :n], v[:, :, :n], enable_gqa=True)
            for k, v in caches for n in lens]

    for got, want in zip(kern(), library()):
        scale = max(1.0, float(want.abs().max()))
        err = float((got.float() - want.reshape(B * H, hd).float())
                    .abs().max()) / scale
        if err >= TOL:
            raise RuntimeError(f"{label}: kernel against sdpa {err}")
    chosen = fa.decode_shape(rows, groups, n_logical, ps)
    real = fa.decode_shape
    times = {}
    try:
        for gr in fa.GROUP_ROWS:
            for want in sorted(set(SPLITS) | {chosen.splits}):
                if want > min(fa.MAX_SPLITS, n_logical):
                    continue
                shape = fa.DecodeShape(want, fa.GROUPED_WARPS, gr)
                fa.decode_shape = forced(shape)
                times[gr, want] = (replay_us(kern, calls),
                                   waves(rows, groups, hd, n_logical, ps,
                                         shape))
    finally:
        fa.decode_shape = real
    pick = replay_us(kern, calls)
    reps = [tuple(t.repeat_interleave(groups, dim=0) for t in p)
            for p in pools[:1]]
    per_row = replay_us(lambda: [
        fa.flash_decode_paged(q, kp, vp, table, n)
        for kp, vp in reps for n in lens], len(lens))
    del reps
    lib = replay_us(library, calls)
    bound = sum(live_bytes(rows, groups, hd, n, ps) for n in lens) \
        / len(lens) / PEAK_BYTES * 1e6
    best = min(times, key=lambda k: times[k][0])
    blocks = rows * -(-groups // chosen.group_rows)
    print(f"{label} (B{B} H{H} KV{KV} hd{hd} bf16, cap {cap}, ps {ps}, "
          f"{len(lens)} calls kv_len {lens[0]}..{lens[-1]}, {copies} cache "
          f"copies): chooser {chosen.group_rows} query rows a block x "
          f"{chosen.splits} splits ({blocks * chosen.splits} blocks), "
          f"{pick:.2f} us a call ({bound / pick * 100:.1f}% of the bytes "
          f"bound {bound:.2f} us); fastest {best[0]} rows x {best[1]} "
          f"splits {times[best][0]:.2f} us; by (rows, splits): us (waves) "
          + ", ".join(f"{g}x{sp}: {t:.2f} ({w:.2f})"
                      for (g, sp), (t, w) in times.items())
          + f"; per-row route on repeated pools {per_row:.2f} us; gather + "
          f"sdpa {lib:.2f} us", flush=True)


def parent_lib(cu: Path):
    """An earlier source of the kernel, built with the port's flags into
    the build directory, its two launch entry points declared with their
    signature before the grouped route (no rows-a-block argument)."""
    out = build.BUILD_DIR / (
        "parent-" + hashlib.sha256(cu.read_bytes()).hexdigest()[:16] + ".so")
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                        str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    sig = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p] \
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    for name in ("flash_decode_paged_f32", "flash_decode_paged_bf16"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = sig, ctypes.c_int
    return lib


def parent_call(lib, q, kp, vp, table, kv_len, groups=1, window=None):
    """One launch of the earlier kernel as its wrapper made it: the split
    count and block width of the per-row rules for ``bh`` query rows, each
    its own block (a grouped call's query rows read their pool row by
    index)."""
    rows, n_pages, ps, hd = kp.shape
    bh, n_logical = rows * groups, len(table)
    out = torch.empty_like(q)
    splits = fa.decode_splits(bh, n_logical)
    fn = (lib.flash_decode_paged_f32 if q.dtype == torch.float32
          else lib.flash_decode_paged_bf16)
    rc = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
            out.data_ptr(), bh, n_pages, n_logical, ps, hd, kv_len, None,
            -1 if window is None else window, splits,
            fa.decode_warps(n_logical, ps, splits),
            int(fa.decode_vec(hd, kp, vp)), groups, 1.0 / math.sqrt(hd),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"earlier flash_decode_paged: cudaError {rc}")
    return out


def in_turns(label, calls, earlier, this) -> None:
    """Time ``earlier`` and ``this`` (each making ``calls`` calls) in
    turns, earlier, this, this, earlier, and print the means."""
    t = {"earlier": [], "this": []}
    for name in ("earlier", "this", "this", "earlier"):
        t[name].append(replay_us(earlier if name == "earlier" else this,
                                 calls))
    a, b = (sum(v) / len(v) for v in t.values())
    print(f"  {label}: earlier kernel {a:.2f} us a call "
          f"({', '.join(f'{x:.2f}' for x in t['earlier'])}), this kernel "
          f"{b:.2f} us ({', '.join(f'{x:.2f}' for x in t['this'])}); "
          f"{a / b:.2f}x", flush=True)


def against_parent(dev, gen, cu: Path) -> None:
    """The per-row route bit-equal to the earlier kernel, and both
    versions timed in turns at the main path's call and the LM's."""
    lib = parent_lib(cu)
    print(f"against the earlier source {cu}:", flush=True)
    n = 0
    for dtype, rows, n_pages in ((torch.float32, 4, 32),
                                 (torch.bfloat16, 8, 96)):
        ps, hd = 16, 128
        q = torch.randn((rows, hd), generator=gen, device=dev).to(dtype)
        kp, vp = (torch.randn((rows, n_pages, ps, hd), generator=gen,
                              device=dev).to(dtype) for _ in range(2))
        table = torch.randperm(n_pages, generator=gen, device=dev).int()
        for kv_len in range(1, n_pages * ps + 1, 7):
            for window in (None, 100):
                a = parent_call(lib, q, kp, vp, table, kv_len,
                                window=window)
                b = fa.flash_decode_paged(q, kp, vp, table, kv_len,
                                          window=window)
                if not torch.equal(a, b):
                    raise RuntimeError(f"per-row route {dtype} kv_len "
                                       f"{kv_len} window {window}: not the "
                                       f"earlier kernel's bits")
                n += 1
    print(f"  the per-row route: {n} calls bit-equal to the earlier "
          f"kernel's (f32 4 heads x 32 pages, bf16 8 heads x 96 pages, hd "
          f"128, every 7th length, window none and 100)", flush=True)
    q = torch.randn((4, 128), generator=gen, device=dev)
    kp, vp = (torch.randn((4, 32, 16, 128), generator=gen, device=dev)
              for _ in range(2))
    table = torch.arange(32, dtype=torch.int32, device=dev)
    in_turns("main path's call (f32, 4 heads, 512 keys)", 1,
             lambda: parent_call(lib, q, kp, vp, table, 512),
             lambda: fa.flash_decode_paged(q, kp, vp, table, 512))
    for label, B, H, KV, hd, cap, lens in CASES[:2]:
        groups, rows = H // KV, B * KV
        ps = page_size(cap)
        table = page_table(cap, dev)
        copies = max(1, -(-ROTATE_BYTES // (4 * rows * cap * hd))) \
            if cap > 1024 else 1
        pools = [tuple(torch.randn((rows, cap // ps, ps, hd), generator=gen,
                                   device=dev).bfloat16() for _ in range(2))
                 for _ in range(copies)]
        q = torch.randn((B * H, hd), generator=gen, device=dev).bfloat16()
        in_turns(f"{label} ({len(lens)} calls, {copies} copies)",
                 copies * len(lens),
                 lambda: [parent_call(lib, q, kp, vp, table, n, groups)
                          for kp, vp in pools for n in lens],
                 lambda: [fa.flash_decode_paged(q, kp, vp, table, n,
                                                groups=groups)
                          for kp, vp in pools for n in lens])
        del pools


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="an earlier flash_decode_paged.cu to hold the "
                    "per-row route against and to time beside this one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_sweep: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    for case in CASES:
        sweep_case(dev, gen, *case)
    if args.parent is not None:
        against_parent(dev, gen, args.parent)
    print(f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
