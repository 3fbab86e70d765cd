"""The port's shard-kernel wrappers against the Pallas kernels.

On the CPU the wrappers run their plain versions (the counterpart of the
reference's interpret mode), so these tests hold the dispatch code, the
geometry rules and the plain arithmetic against the JAX package's Pallas
kernels run in interpret mode, on the reference's own conformance grid
(kernels up to 3x3 here; the 5x5 and 7x7 geometries, whose interpret-mode
compiles dominate, in ``test_torch_kernels_wide.py``).  The CUDA kernels
themselves are held against the plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import functools
import importlib
import re
import shutil
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import matmul_tiled as j_matmul_tiled
from repro.kernels.ref import conv2d_shard_ref as j_conv2d_shard_ref

from repro_torch import AnalyticEstimator, plan_search
from repro_torch import Testbed as TorchTestbed
from repro_torch.configs.edge_models import EDGE_MODELS
from repro_torch.core.graph import ConvT
from repro_torch.core.plan import steps_segments
from repro_torch.kernels import build, gemm, ops
from repro_torch.kernels.conv2d import (UnsupportedGeometry, conv2d_shard,
                                        shard_out_shape)
from repro_torch.kernels.ops import matmul_tiled
from repro_torch.kernels.ref import conv2d_shard_ref, matmul_ref
from repro_torch.runtime.engine import (_segment_records, backward_chain,
                                        exact_regions)

from torch_conformance import CONV_GEOMS, check_conv_grid, geom_id, rel_err

NARROW = [g for g in CONV_GEOMS if g[1] <= 3]


def test_grid_split_covers_every_geometry():
    wide = [g for g in CONV_GEOMS if g[1] > 3]
    assert sorted(NARROW + wide) == CONV_GEOMS and NARROW and wide


@pytest.mark.parametrize("t,k,s,p", NARROW, ids=[geom_id(g) for g in NARROW])
def test_conv_grid_all_halo_pads(t, k, s, p):
    check_conv_grid(t, k, s, p)


@pytest.mark.parametrize("m,cin,cout", [(16, 32, 96), (1, 32, 10),
                                        (37, 16, 100), (128, 64, 3),
                                        (300, 7, 9)])
def test_fc_matmul_grid(m, cin, cout):
    """The reference's FC shard shapes, with the weight also passed as the
    plan's column slice of a wider weight."""
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, cin)).astype(np.float32)
    w = (rng.standard_normal((cin, cout + 6)) * 0.1).astype(np.float32)
    ref = j_matmul_tiled(jnp.asarray(x), jnp.asarray(w[:, 3:3 + cout]))
    for wt in (torch.from_numpy(w[:, 3:3 + cout].copy()),
               torch.from_numpy(w)[:, 3:3 + cout]):
        out = matmul_tiled(torch.from_numpy(x), wt)
        assert rel_err(out, ref) < 1e-5


def test_unsupported_geometries_raise():
    """The reference's UnsupportedGeometry cases raise the same here."""
    x = torch.randn(2, 8, 4)
    w = torch.randn(3, 3, 4, 4)
    with pytest.raises(UnsupportedGeometry):
        conv2d_shard(x, w)                  # out_h == 0
    with pytest.raises(UnsupportedGeometry):
        conv2d_shard(x[:, :2], w)           # out_w == 0
    with pytest.raises(UnsupportedGeometry):
        matmul_tiled(torch.zeros((0, 4)), torch.zeros((4, 3)))
    with pytest.raises(UnsupportedGeometry):
        conv2d_shard(torch.randn(6, 6, 4), torch.randn(3, 2, 4, 4))
    with pytest.raises(UnsupportedGeometry):
        conv2d_shard(torch.randn(6, 6, 4), w, stride=0)
    assert shard_out_shape(2, 8, 3, 1, (0, 0, 0, 0)) == (0, 6)


def test_wrappers_fall_back_only_on_geometry():
    """ops.conv2d/dwconv2d/matmul take the plain version on unsupported
    geometry; a bad shape or device placement raises instead."""
    x = torch.randn(2, 8, 4)
    w = torch.randn(3, 3, 4, 4)
    assert tuple(ops.conv2d(x, w).shape) == (0, 6, 4)
    assert tuple(ops.dwconv2d(x, torch.randn(3, 3, 1, 4)).shape) == \
        (0, 6, 4)
    assert tuple(ops.matmul(torch.zeros(0, 4), torch.ones(4, 3)).shape) == \
        (0, 3)
    xs = torch.randn(9, 9, 4)
    assert rel_err(ops.conv2d(xs, w, padding=1, stride=2),
                    conv2d_shard_ref(xs, w, pads=(1, 1, 1, 1),
                                     stride=2)) == 0.0
    with pytest.raises(ValueError, match="weight shape"):
        conv2d_shard(xs, torch.randn(3, 3, 5, 4))
    with pytest.raises(ValueError, match="chain"):
        matmul_tiled(torch.randn(3, 4), torch.randn(5, 2))
    # a tensor neither on the CPU nor on CUDA is refused, not swallowed
    # as an unsupported geometry
    meta = torch.empty(9, 9, 4, device="meta")
    with pytest.raises(TypeError):
        conv2d_shard(meta, w.to("meta"))
    with pytest.raises(TypeError):
        matmul_tiled(torch.empty(3, 4, device="meta"), torch.randn(4, 2))


def test_kernel_build_is_lazy_and_keyed_by_source(monkeypatch, tmp_path):
    """Importing the kernels builds nothing; the library path is a pure
    function of the source, the shared headers and the flags, one per
    source: editing a header moves every library, editing one source moves
    only its own."""
    assert build._LOADED == {}
    assert set(build.SIGNATURES) == {p.stem for p in build.CSRC.glob("*.cu")}
    for name in build.SIGNATURES:
        p = build.lib_path(name)
        assert p == build.lib_path(name)
        assert p.parent == build.BUILD_DIR and p.name.startswith(name)
    assert build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS

    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    headers = sorted(copy.glob("*.cuh"))
    assert [h.name for h in headers] == ["gemm_f32.cuh"]
    before = {n: build.lib_path(n) for n in build.SIGNATURES}
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {n: build.lib_path(n) for n in build.SIGNATURES}
    assert all(after[n] != before[n] for n in build.SIGNATURES)
    src = copy / "matmul_tiled.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    again = {n: build.lib_path(n) for n in build.SIGNATURES}
    assert {n for n in build.SIGNATURES if again[n] != after[n]} == \
        {"matmul_tiled"}


def test_kernel_build_without_toolkit_raises(monkeypatch, tmp_path):
    """With no CUDA compiler the build raises RuntimeError — never an
    UnsupportedGeometry the engine would swallow."""
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(build, "CUDA_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc()
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_all()
    assert not (tmp_path / "build").exists()


def test_cpu_dispatch_does_not_count_launches():
    """The counters count kernel launches only; the plain versions that
    CPU tensors run do not move them."""
    before = (conv2d_shard.launches, matmul_tiled.launches)
    conv2d_shard(torch.randn(5, 5, 3), torch.randn(3, 3, 3, 2))
    matmul_tiled(torch.randn(2, 3), torch.randn(3, 4))
    assert (conv2d_shard.launches, matmul_tiled.launches) == before
    assert isinstance(conv2d_shard.launches, int)
    assert isinstance(matmul_tiled.launches, int)


def test_plain_versions_agree_with_reference_oracles():
    """matmul_ref / conv2d_shard_ref against the JAX package's oracles on
    a wider strided shard with asymmetric pads and on a classifier-head
    FC shape ([1, 1024] @ [1024, 1000])."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((7, 7, 64)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 64, 48)) * 0.05).astype(np.float32)
    ref = j_conv2d_shard_ref(jnp.asarray(x), jnp.asarray(w),
                             pads=(1, 0, 0, 1), stride=2)
    out = conv2d_shard_ref(torch.from_numpy(x), torch.from_numpy(w),
                           pads=(1, 0, 0, 1), stride=2)
    assert rel_err(out, ref) < 1e-5
    xm = rng.standard_normal((1, 1024)).astype(np.float32)
    wm = (rng.standard_normal((1024, 1000)) * 0.03).astype(np.float32)
    assert rel_err(matmul_ref(torch.from_numpy(xm), torch.from_numpy(wm)),
                    np.asarray(jnp.asarray(xm) @ jnp.asarray(wm))) < 1e-5


# ---------------------------------------------------------------------------
# host side of the shared implicit-GEMM tile loop (kernels/gemm.py)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def main_path_gemms(name, nodes=4):
    """The distinct (M, N, K) products the dense conv and FC shard
    records of ``name``'s searched plan hand to the tile loop at
    ``nodes`` nodes (the chip smoke run's main path)."""
    graph = EDGE_MODELS[name]()
    plan = plan_search(graph, AnalyticEstimator(),
                       TorchTestbed(nodes=nodes, bandwidth_gbps=0.5)).plan
    out = set()

    def branch(layers, steps):
        for a, b in steps_segments(steps):
            for cells in exact_regions(layers[b], steps[a][0], nodes):
                for reg in cells:
                    need, in_rect = backward_chain(layers, a, b, reg)
                    recs = _segment_records(layers, a, b, need, in_rect)
                    rows = in_rect[0][1] - in_rect[0][0]
                    for li, (t, k, s, pads, sl, chans) in zip(
                            range(a, b + 1), recs):
                        t, cin = ConvT(t), layers[li].in_c
                        width = chans[1] - chans[0]
                        if t == ConvT.FC and rows > 0:
                            out.add((rows, width, cin))
                        elif t in (ConvT.CONV, ConvT.POINTWISE):
                            oh, ow = shard_out_shape(
                                sl[1] - sl[0], sl[3] - sl[2], k, s, pads)
                            if oh > 0 and ow > 0:
                                out.add((oh * ow, width, k * k * cin))
                        rows = need[li][0][1] - need[li][0][0]

    if graph.is_chain:
        branch(graph.layers, plan.steps)
    else:
        for br in graph.linearize():
            ids = list(br.ids)
            rest = ids[1:] if graph.fan_in(ids[0]) >= 2 else ids
            if rest:
                branch([graph.layers[i] for i in rest],
                       [plan.steps[i] for i in rest])
    return sorted(out)


MAIN_MODELS = ("bert", "mobilenet", "resnet18")
ODD_GEMMS = [(1, 1, 1), (1, 200, 100), (7, 9, 300), (37, 100, 16),
             (128, 2304, 768), (300, 9, 7), (64, 64, 4609),
             (4096, 4096, 4096), (5000, 3, 27)]


def test_main_path_gemm_shapes_are_the_known_ones():
    """The plans give bert its four [32, K] @ [K, N] shard products and
    the classifier heads their [1, K] @ [K, 250] column shards."""
    assert main_path_gemms("bert") == [(32, 768, 2304), (32, 768, 3072),
                                       (32, 2304, 768), (32, 3072, 768)]
    assert (1, 250, 1024) in main_path_gemms("mobilenet")
    assert (1, 250, 512) in main_path_gemms("resnet18")
    assert (14, 512, 4608) in main_path_gemms("resnet18")   # [4, 7, 512]
    assert any(k == 147 for _, _, k in main_path_gemms("resnet18"))  # stem
    assert any(k == 27 for _, _, k in main_path_gemms("mobilenet"))  # stem


@pytest.mark.parametrize("shapes", list(MAIN_MODELS) + ["odd"])
def test_gemm_plan_k_chunks_cover_k_exactly_once(shapes):
    """Every split sums a non-empty, slab-aligned K range; together they
    tile [0, K) with no gap and no overlap; the grid's tiles cover M x N."""
    for m, n, k in ODD_GEMMS if shapes == "odd" else main_path_gemms(shapes):
        plan = gemm.plan_gemm(m, n, k)
        cfg = plan.cfg
        assert cfg in gemm.CONFIGS
        assert plan.kchunk % cfg.bk == 0
        assert 1 <= plan.splits <= gemm.MAX_SPLITS
        ranges = [(s * plan.kchunk, min(k, (s + 1) * plan.kchunk))
                  for s in range(plan.splits)]    # what each split sums
        assert ranges[0][0] == 0 and ranges[-1][1] == k
        assert all(lo < hi for lo, hi in ranges)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert plan.m_tiles == -(-m // cfg.bm)
        assert plan.n_tiles == -(-n // cfg.bn)
        assert plan.blocks == plan.m_tiles * plan.n_tiles * plan.splits


@pytest.mark.parametrize("shapes", list(MAIN_MODELS) + ["odd"])
def test_mma_plan_k_chunks_cover_k_exactly_once(shapes):
    """The tensor-core plans of the same products: a tensor-core config;
    every split a non-empty, slab-aligned K range, together [0, K) once;
    a split plan an [splits, M, N] f32 workspace, an unsplit one none."""
    for m, n, k in ODD_GEMMS if shapes == "odd" else main_path_gemms(shapes):
        plan = gemm.plan_gemm(m, n, k, True)
        cfg = plan.cfg
        assert cfg.mma and cfg in gemm.configs_for(True)
        assert plan.kchunk % cfg.bk == 0
        assert 1 <= plan.splits <= gemm.MAX_SPLITS
        assert (plan.splits - 1) * plan.kchunk < k <= \
            plan.splits * plan.kchunk
        assert plan.m_tiles == -(-m // cfg.bm)
        assert plan.n_tiles == -(-n // cfg.bn)
        ws = gemm.workspace(plan, m, n, torch.device("cpu"))
        if plan.splits > 1:
            assert tuple(ws.shape) == (plan.splits, m, n)
            assert ws.dtype == torch.float32
        else:
            assert ws is None


@pytest.mark.parametrize("want", [1, 2, 8, 9, 32])
def test_split_plan_keeps_to_the_splits_asked(want):
    """Every config, on either loop, plans at most the K chunks it is
    asked for, each a whole number of its slabs, together covering K."""
    for cfg in gemm.CONFIGS:
        plan = gemm.split_plan(cfg, 32, 768, 4608, want)
        assert 1 <= plan.splits <= want
        assert plan.kchunk % cfg.bk == 0
        assert (plan.splits - 1) * plan.kchunk < 4608 <= \
            plan.splits * plan.kchunk


@pytest.mark.parametrize("name", MAIN_MODELS)
def test_gemm_plan_fills_the_card_on_the_main_path(name):
    """Each dense conv and FC shard of the main path at 4 nodes: the
    weight-streaming shards (M <= 32) launch at least one block per SM
    where whole slabs allow it; the many-pixel conv shards, whose split
    costs [splits, M, N] of workspace traffic, fill between half a wave
    and one wave (or run unsplit)."""
    for m, n, k in main_path_gemms(name):
        plan = gemm.plan_gemm(m, n, k)
        tiles = plan.m_tiles * plan.n_tiles
        most = tiles * min(-(-k // plan.cfg.bk), gemm.MAX_SPLITS)
        if plan.cfg == gemm.PIXELS:
            assert plan.blocks >= min(most, gemm.SMS // 2), (m, n, k, plan)
            assert plan.splits == 1 or plan.blocks <= gemm.SMS, plan
        else:
            assert plan.blocks >= min(most, gemm.SMS), (m, n, k, plan)


def test_gemm_plan_picks_the_tile_by_rows():
    """bert's 32-row shards take the 32-row, 2-group tile; the heads the
    8-row GEMV tile; many-pixel conv shards the 32-row, 4-group tile."""
    assert gemm.plan_gemm(32, 2304, 768).cfg == gemm.SKINNY
    assert gemm.plan_gemm(32, 2304, 768).splits == 8     # 36 x 8 blocks
    assert gemm.plan_gemm(32, 768, 3072).splits == 32    # 12 x 32 blocks
    assert gemm.plan_gemm(1, 250, 1024).cfg == gemm.GEMV
    assert gemm.plan_gemm(1, 250, 1024).splits == 32     # one slab each
    assert gemm.plan_gemm(14, 512, 4608).cfg == gemm.SKINNY
    assert gemm.plan_gemm(784, 64, 576).cfg == gemm.PIXELS
    assert gemm.plan_gemm(3248, 64, 147).splits == 1     # 102 tiles
    assert gemm.plan_gemm(5, 7, 3).blocks == 1


def test_gemm_configs_match_the_cuda_switch():
    """CONFIGS mirrors the cases of gemm_f32::launch: at each index the
    loop (fma_cfg: CUDA cores, mma_cfg: tensor cores) and <BM, BK, TM or
    MI, KG, stages>, three stages in every case.  CUDA cores: 16 thread
    columns of 4 outputs each (a 64-wide tile), each K group a whole
    number of float4 steps deep.
    Tensor cores: four warps tile BM rows in m16 fragments and 64
    columns in pairs of n8 fragments, each K group whole k16 steps
    deep."""
    src = (build.CSRC / "gemm_f32.cuh").read_text()
    cases = re.findall(r"case (\d+):[^\n]*\n\s*return (fma|mma)_cfg<(\d+), "
                       r"(\d+), (\d+), (\d+), 3>", src)
    assert [(int(i), loop == "mma", int(bm), int(bk), int(tm), int(kg))
            for i, loop, bm, bk, tm, kg in cases] == \
        [(c.index, c.mma, c.bm, c.bk, c.tm, c.kg) for c in gemm.CONFIGS]
    assert [c.index for c in gemm.CONFIGS] == list(range(len(gemm.CONFIGS)))
    assert "constexpr int kBN = kTX * 4;" in src
    assert "constexpr int kTX = 16;" in src
    for c in gemm.CONFIGS:
        assert c.bn == 64
        if c.mma:
            wm = c.bm // (16 * c.tm)
            assert wm * 16 * c.tm == c.bm and 4 % wm == 0, c
            assert (c.bn // (8 * (4 // wm))) % 2 == 0, c
            assert c.bk % (16 * c.kg) == 0, c
        else:
            assert c.bm // c.tm * 16 == 128 and c.bk % (4 * c.kg) == 0, c
    assert gemm.configs_for(False) + gemm.configs_for(True) == gemm.CONFIGS
    assert not any(c.mma for c in gemm.configs_for(False))
    assert all(c.mma for c in gemm.configs_for(True))


#: (x dtype, w dtype, the dense loop the pair runs on): x and w in one
#: 2-byte dtype on the tensor cores; f32, a 2-byte x with f32 weights,
#: and the pairs the wrapper upcasts to f32 weights on CUDA cores
ROUTE_PAIRS = [
    (torch.bfloat16, torch.bfloat16, "tensor_cores"),
    (torch.float16, torch.float16, "tensor_cores"),
    (torch.float32, torch.float32, "cuda_cores"),
    (torch.bfloat16, torch.float32, "cuda_cores"),
    (torch.float16, torch.float32, "cuda_cores"),
    (torch.float32, torch.bfloat16, "cuda_cores"),
    (torch.float32, torch.float16, "cuda_cores"),
    (torch.bfloat16, torch.float16, "cuda_cores"),
    (torch.float16, torch.bfloat16, "cuda_cores"),
]


@pytest.mark.parametrize("kernel", ["matmul", "conv", "depthwise"])
@pytest.mark.parametrize("xd,wd,route", ROUTE_PAIRS,
                         ids=[f"{str(a)[6:]}-{str(b)[6:]}"
                              for a, b, _ in ROUTE_PAIRS])
def test_the_tensor_cores_take_only_same_type_2_byte_pairs(
        monkeypatch, kernel, xd, wd, route):
    """The wrappers' CUDA branch, run with a stand-in library: a same-type
    bf16 or fp16 pair gets a tensor-core config, every other pair a
    CUDA-core one, at the main path's FC and conv shard shapes; the
    depthwise kernel plans no tile loop.  Each call counts one launch on
    its route, and the arguments match the declared C signature."""
    conv_mod = importlib.import_module("repro_torch.kernels.conv2d")
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    planned = []
    real_plan = gemm.plan_gemm

    def plan(*args):
        planned.append(args)
        return real_plan(*args)

    monkeypatch.setattr(conv_mod, "on_cpu", lambda *a, **k: False)
    monkeypatch.setattr(build, "load", lambda name: Lib())
    monkeypatch.setattr(gemm, "plan_gemm", plan)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    if kernel == "matmul":
        wrapper, entry, at = matmul_tiled, "matmul_tiled", 10
        cases = [(torch.zeros(m, k, dtype=xd),
                  torch.zeros(k, n, dtype=wd), {})
                 for m, k, n in ((32, 768, 2304), (32, 3072, 768),
                                 (1, 1024, 250), (128, 768, 2304))]
    else:
        wrapper, entry, at = conv2d_shard, "conv2d_shard", 20
        dw = kernel == "depthwise"
        cases = [(torch.zeros(rows, width, cin, dtype=xd),
                  torch.zeros(k, k, 1 if dw else cin, cout, dtype=wd),
                  dict(pads=pads, stride=s, depthwise=dw))
                 for rows, width, cin, cout, k, s, pads in (
                     (16, 56, 64, 64, 3, 1, (0, 0, 1, 1)),
                     (4, 7, 512, 512, 3, 1, (0, 0, 1, 1)),
                     (63, 224, 3, 64, 7, 2, (0, 0, 3, 2)))
                 if not dw or cin == cout]
    n0, r0 = wrapper.launches, dict(wrapper.routes)
    for x, w, kw in cases:
        out = wrapper(x, w, **kw)
        assert out.dtype == xd
    taken = "depthwise" if kernel == "depthwise" else route
    assert wrapper.launches - n0 == len(cases)
    assert {r: wrapper.routes[r] - n for r, n in r0.items()} == \
        {r: len(cases) if r == taken else 0 for r in r0}
    suffix = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.float16: "f16"}[xd]
    if route == "cuda_cores" and xd != torch.float32:
        suffix += "_f32"
    kind = {"matmul": "", "conv": "dense_", "depthwise": "dw_"}[kernel]
    name = f"{entry}_{kind}{suffix}"
    assert [c[0] for c in calls] == [name] * len(cases)
    assert all(len(args) == len(build.SIGNATURES[entry][name])
               for _, args in calls)
    if kernel == "depthwise":
        assert planned == []
        return
    assert [a[-1] for a in planned] == [route == "tensor_cores"] * len(cases)
    for _, args in calls:
        cfg = gemm.CONFIGS[args[at]]
        assert cfg.mma == (route == "tensor_cores"), cfg
        assert cfg in gemm.configs_for(cfg.mma)


@pytest.mark.parametrize("m,n,k", [(32, 2304, 768), (1, 250, 512),
                                   (14, 512, 4608), (3248, 32, 27)])
def test_gemm_workspace_shape(m, n, k):
    plan = gemm.plan_gemm(m, n, k)
    ws = gemm.workspace(plan, m, n, torch.device("cpu"))
    if plan.splits == 1:
        assert ws is None
    else:
        assert tuple(ws.shape) == (plan.splits, m, n)
        assert ws.dtype == torch.float32 and ws.is_contiguous()


def test_gemm_plan_rejects_an_empty_product():
    with pytest.raises(ValueError):
        gemm.plan_gemm(0, 4, 4)


def test_vector_routes_follow_alignment():
    """16-byte copies only where every address they form is 16-byte
    aligned: Cin % 4 == 0 for the activations, a unit output-channel
    stride for the weight, aligned pointers, strides multiples of 4."""
    x = torch.zeros(6, 9, 20)
    assert gemm.x_vec(x, 20)
    assert not gemm.x_vec(x[:, :, :3], 3)            # Cin = 3 stem
    assert not gemm.x_vec(x[:, :, 1:17], 16)          # pointer off by 4 B
    assert gemm.x_vec(x[1:, 2:, 4:12], 8)             # aligned halo view
    assert not gemm.x_vec(torch.zeros(5, 7, 3)[:, :, :2], 2)
    head = torch.zeros(1024, 1000)
    assert gemm.w_vec(head)
    # the odd node's OutC column view starts 1000 bytes past an aligned
    # pointer; the even ones 2000 bytes (aligned) with ldw 1000
    assert gemm.w_vec(head[:, 0:250]) and gemm.w_vec(head[:, 500:750])
    assert not gemm.w_vec(head[:, 250:500])
    assert not gemm.w_vec(head[:, 750:1000])
    assert not gemm.w_vec(torch.zeros(3, 3, 4, 6).transpose(2, 3))
    assert not gemm.w_vec(torch.zeros(3, 3, 5, 3))     # strides 45, 15, 3
    assert gemm.w_vec(torch.zeros(3, 3, 64, 72)[..., 4:68])


def test_gemm_sweep_needs_a_card(monkeypatch, capsys):
    """The config sweep is a card-only tool: without CUDA it exits 2 and
    times nothing."""
    from repro_torch.kernels import gemm_sweep
    monkeypatch.setattr(gemm_sweep.torch.cuda, "is_available", lambda: False)
    assert gemm_sweep.main() == 2
    assert "no CUDA device" in capsys.readouterr().err
