"""The CUDA kernels, the ``backend="cuda"`` engine, the mesh executor and
the ``backend="cuda"`` decode session on the card.

Every test here needs a CUDA device: it carries the ``gpu`` marker and
skips (inside the ``cuda`` fixture, never at import) where there is none.
The file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors; the tolerance is the reference's scale-normalised 1e-4, because
the kernel and the plain version sum in f32 in different orders (TF32 is
switched off for the plain versions).
"""
import importlib
import importlib.util
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import (AnalyticEstimator, DecodeSession, ExecConfig, Mode,
                         Plan, Scheme, Session, TransformerSpec, fixed_plan,
                         greedy_decode, init_transformer, init_weights,
                         plan_decode, plan_search, reference_decode,
                         run_reference)
from repro_torch import Testbed as TorchTestbed
from repro_torch import obs
from repro_torch.configs.edge_models import EDGE_MODELS, resnet18
from repro_torch.core.graph import (ConvT, LayerSpec, chain, conv_geometries,
                                    shard_halo_pads)
from repro_torch.kernels import build, gemm, ops
from repro_torch.kernels.conv2d import conv2d_shard, shard_out_shape
from repro_torch.kernels.flash_attention import (flash_attention_bh,
                                                 flash_decode_paged)
from repro_torch.kernels.ops import matmul_tiled
from repro_torch.kernels.ref import (conv2d_shard_ref, flash_attention_ref,
                                     flash_decode_paged_ref, live_pages,
                                     matmul_ref)
from repro_torch.runtime.engine import (clear_segment_cache,
                                        segment_cache_info)
from repro_torch.launch.mesh import NodesMesh
from repro_torch.runtime import mesh_exec
from repro_torch.runtime.graphs import GraphProgram
from repro_torch.runtime.mesh_exec import (StageTimeoutError,
                                           clear_mesh_program_cache,
                                           mesh_program_cache_info)

fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")

pytestmark = pytest.mark.gpu

SMALL = {
    "mobilenet": dict(width=32),
    "resnet18": dict(width=32),
    "resnet101": dict(width=32),
    "inception": dict(width=32),
    "bert": dict(seq=16, d=32, n_layers=1, d_ff=64),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = (torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    yield torch.device("cuda")
    torch.cuda.synchronize()
    torch.backends.cudnn.allow_tf32 = prev[0]
    torch.set_float32_matmul_precision(prev[1])


def _rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    assert a.shape == b.shape
    if b.numel() == 0:
        return 0.0
    scale = max(1.0, float(b.abs().max()))
    return float((a.float() - b.float()).abs().max()) / scale


def _conv_geoms():
    geoms = set()
    for name, f in EDGE_MODELS.items():
        geoms.update(conv_geometries(f()))
        geoms.update(conv_geometries(f(**SMALL[name])))
    return sorted(g for g in geoms
                  if g[0] in (ConvT.CONV, ConvT.DWCONV, ConvT.POINTWISE))


CONV_GEOMS = _conv_geoms()


@pytest.mark.parametrize("t,k,s,p", CONV_GEOMS,
                         ids=[f"{t.name}-k{k}-s{s}-p{p}"
                              for t, k, s, p in CONV_GEOMS])
def test_conv_kernel_matches_plain(cuda, t, k, s, p):
    gen = torch.Generator(device=cuda).manual_seed(k * 100 + s * 10 + p)
    cin, cout = 19, 70
    dw = t == ConvT.DWCONV
    if dw:
        w = torch.randn((k, k, 1, cin), generator=gen, device=cuda)
    else:   # an OutC weight view of a wider tensor
        w = torch.randn((k, k, cin, cout + 9), generator=gen,
                        device=cuda)[..., 4:4 + cout]
    for pads in shard_halo_pads(p):
        h = 2 * k + 5 * s - pads[0] - pads[1]
        wd = 2 * k + 4 * s + 3 - pads[2] - pads[3]
        big = torch.randn((h + 2, wd + 3, cin + 2), generator=gen,
                          device=cuda)
        for x in (big[1:1 + h, 2:2 + wd, 1:1 + cin],
                  big[1:1 + h, 2:2 + wd, 1:1 + cin].contiguous()):
            n0 = conv2d_shard.launches
            out = conv2d_shard(x, w, pads=pads, stride=s, depthwise=dw)
            assert conv2d_shard.launches == n0 + 1
            ref = conv2d_shard_ref(x, w, pads=pads, stride=s, depthwise=dw)
            torch.cuda.synchronize()
            assert _rel_err(out, ref) < 1e-4, (pads, x.is_contiguous())


@pytest.mark.parametrize("m,cin,cout", [(1, 1024, 1000), (1, 512, 250),
                                        (128, 768, 2304), (128, 3072, 768),
                                        (37, 16, 100), (300, 7, 9)])
def test_matmul_kernel_matches_plain(cuda, m, cin, cout):
    gen = torch.Generator(device=cuda).manual_seed(m + cin)
    x = torch.randn((m, cin), generator=gen, device=cuda)
    wide = torch.randn((cin, cout + 5), generator=gen, device=cuda) * 0.05
    for w in (wide[:, 2:2 + cout], wide[:, 2:2 + cout].contiguous()):
        n0 = matmul_tiled.launches
        out = matmul_tiled(x, w)
        assert matmul_tiled.launches == n0 + 1
        assert _rel_err(out, matmul_ref(x, w)) < 1e-4


def test_wrappers_raise_on_operands_the_kernels_do_not_take(cuda):
    x = torch.randn(8, 8, 4, device=cuda)
    w = torch.randn(3, 3, 4, 5, device=cuda)
    with pytest.raises(TypeError):
        conv2d_shard(x.double(), w.double())
    with pytest.raises(TypeError):
        conv2d_shard(x, w.cpu())
    with pytest.raises(RuntimeError, match="channel stride"):
        # channel-first storage viewed as [H, W, C]: channel stride 64
        conv2d_shard(torch.randn(4, 8, 8, device=cuda).permute(1, 2, 0), w)
    with pytest.raises(RuntimeError, match="unit column strides"):
        matmul_tiled(torch.randn(4, 6, device=cuda).t(),
                     torch.randn(4, 3, device=cuda))


# ---------------------------------------------------------------------------
# the implicit-GEMM tile loop at the main path's shapes, every route
# ---------------------------------------------------------------------------

def _forced(cfg, splits):
    """A plan_gemm stand-in that takes tile config ``cfg`` and (at most)
    ``splits`` K chunks, to drive one route of the tile loop."""
    return lambda m, n, k: gemm.split_plan(cfg, m, n, k, splits)


def _route(plan, x, cin, w):
    return (plan.cfg.index, plan.splits > 1, gemm.x_vec(x, cin),
            gemm.w_vec(w))


@pytest.mark.parametrize("m,cin,cout", [(32, 768, 2304), (32, 2304, 768),
                                        (32, 768, 3072), (32, 3072, 768)])
def test_matmul_kernel_on_bert_shard_shapes(cuda, m, cin, cout):
    """bert-base's INH shards at 4 nodes: 32 of 128 rows; split K."""
    gen = torch.Generator(device=cuda).manual_seed(cin + cout)
    x = torch.randn((m, cin), generator=gen, device=cuda)
    w = torch.randn((cin, cout), generator=gen, device=cuda) / cin ** 0.5
    plan = gemm.plan_gemm(m, cout, cin)
    assert plan.splits > 1 and plan.blocks >= gemm.SMS
    n0 = matmul_tiled.launches
    out = matmul_tiled(x, w)
    assert matmul_tiled.launches == n0 + 1
    assert _rel_err(out, matmul_ref(x, w)) < 1e-4


@pytest.mark.parametrize("cin", [512, 1024])
def test_matmul_kernel_on_head_column_views(cuda, cin):
    """The classifier heads at 4 nodes: [1, cin] @ w[:, c0:c0+250] with
    ldw 1000; odd nodes' views start 1000 bytes past a 16-byte boundary
    and take the 4-byte weight route."""
    gen = torch.Generator(device=cuda).manual_seed(cin)
    x = torch.randn((1, cin), generator=gen, device=cuda)
    w = torch.randn((cin, 1000), generator=gen, device=cuda) / cin ** 0.5
    routes = set()
    for node in range(4):
        wv = w[:, 250 * node:250 * (node + 1)]
        assert wv.stride() == (1000, 1)
        routes.add(gemm.w_vec(wv))
        out = matmul_tiled(x, wv)
        assert _rel_err(out, matmul_ref(x, wv)) < 1e-4, node
    assert routes == {True, False}


@pytest.mark.parametrize("cfg", gemm.CONFIGS, ids=lambda c: f"bm{c.bm}")
def test_kernels_with_k_off_the_slab(cuda, monkeypatch, cfg):
    """K not a multiple of any slab depth, with and without a split: the
    last slab's ragged end is zero-filled, not read."""
    gen = torch.Generator(device=cuda).manual_seed(cfg.index)
    for splits in (1, 3):
        monkeypatch.setattr(gemm, "plan_gemm", _forced(cfg, splits))
        for m, k, n in ((cfg.bm - 3, 37, 70), (cfg.bm + 5, 101, 130)):
            x = torch.randn((m, k), generator=gen, device=cuda)
            w = torch.randn((k, n), generator=gen, device=cuda)
            assert _rel_err(matmul_tiled(x, w), matmul_ref(x, w)) < 1e-4
        x = torch.randn((6, 7, 19), generator=gen, device=cuda)   # K = 171
        w = torch.randn((3, 3, 19, 33), generator=gen, device=cuda)
        out = conv2d_shard(x, w, pads=(1, 0, 1, 1), stride=1)
        ref = conv2d_shard_ref(x, w, pads=(1, 0, 1, 1), stride=1)
        assert _rel_err(out, ref) < 1e-4


@pytest.mark.parametrize("rows", [4, 2])
def test_conv_kernel_on_resnet_late_skinny_shards(cuda, rows):
    """ResNet-18's 3x3 512->512 shards at 4 nodes ([4, 7, 512] and
    [2, 7, 512] slices, 7-14 output pixels, K = 4608) on every pad
    signature a shard of a padding-1 conv can occupy."""
    gen = torch.Generator(device=cuda).manual_seed(rows)
    w = torch.randn((3, 3, 512, 512), generator=gen, device=cuda) / 48.0
    big = torch.randn((rows + 2, 9, 512), generator=gen, device=cuda)
    x = big[1:1 + rows, 1:8]
    for pads in shard_halo_pads(1):
        if shard_out_shape(rows, 7, 3, 1, pads)[0] <= 0:
            continue
        out = conv2d_shard(x, w, pads=pads, stride=1)
        ref = conv2d_shard_ref(x, w, pads=pads, stride=1)
        torch.cuda.synchronize()
        assert _rel_err(out, ref) < 1e-4, pads


@pytest.mark.parametrize("k,rows", [(3, 59), (7, 63)])
def test_conv_kernel_on_cin3_stems_on_strided_views(cuda, k, rows):
    """The Cin = 3 stems (MobileNet 3x3/2, ResNet-18 7x7/2) on halo views
    of the 224-wide input: 12-byte pixels, 4-byte activation route, K =
    27 and 147 over the flattened (kh, kw, ci) index."""
    gen = torch.Generator(device=cuda).manual_seed(k)
    cout = 32 if k == 3 else 64
    w = torch.randn((k, k, 3, cout), generator=gen, device=cuda) / k
    img = torch.randn((224, 230, 3), generator=gen, device=cuda)
    p = k // 2
    for r0, pads in ((0, (p, 0, p, p - 1)), (50, (0, 0, p, p - 1)),
                     (224 - rows, (0, p - 1, p, p - 1))):
        x = img[r0:r0 + rows, 3:227]
        assert not gemm.x_vec(x, 3)
        out = conv2d_shard(x, w, pads=pads, stride=2)
        ref = conv2d_shard_ref(x, w, pads=pads, stride=2)
        torch.cuda.synchronize()
        assert _rel_err(out, ref) < 1e-4, (r0, pads)


def test_pointwise_conv_kernel_with_pads_and_stride(cuda):
    """A 1x1 conv takes the tile loop's one-tap path; a pad row or column
    there is zero, as in the general path."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((7, 9, 20), generator=gen, device=cuda)[:, 1:8, :16]
    w = torch.randn((1, 1, 16, 24), generator=gen, device=cuda)
    for pads, s in (((1, 0, 2, 1), 1), ((0, 1, 1, 0), 2), ((2, 2, 2, 2), 3)):
        out = conv2d_shard(x, w, pads=pads, stride=s)
        ref = conv2d_shard_ref(x, w, pads=pads, stride=s)
        torch.cuda.synchronize()
        assert _rel_err(out, ref) < 1e-4, (pads, s)


def test_every_route_of_the_tile_loop(cuda, monkeypatch):
    """Each tile config x split or not x 16- or 4-byte activation copies x
    16- or 4-byte weight copies, on matmul and on a strided conv shard."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    seen = set()
    for cfg in gemm.CONFIGS:
        for splits in (1, 4):
            monkeypatch.setattr(gemm, "plan_gemm", _forced(cfg, splits))
            m, k, n = cfg.bm + 3, 96, 72
            xb = torch.randn((m, k + 4), generator=gen, device=cuda)
            wb = torch.randn((k, n + 4), generator=gen, device=cuda)
            for x in (xb[:, :k], xb[:, 1:1 + k]):
                for w in (wb[:, 4:4 + n], wb[:, 1:1 + n]):
                    seen.add(_route(gemm.plan_gemm(m, n, k), x, k, w))
                    assert _rel_err(matmul_tiled(x, w),
                                    matmul_ref(x, w)) < 1e-4
            cb = torch.randn((9, 10, 36), generator=gen, device=cuda)
            wc = torch.randn((3, 3, 32, 40), generator=gen, device=cuda)
            for x in (cb[1:8, 1:9, 4:36], cb[1:8, 1:9, 3:35]):
                for w in (wc[..., 4:36], wc[..., 1:33]):
                    out = conv2d_shard(x, w, pads=(0, 1, 1, 0), stride=1)
                    ref = conv2d_shard_ref(x, w, pads=(0, 1, 1, 0),
                                           stride=1)
                    assert _rel_err(out, ref) < 1e-4
    assert seen == {(c.index, sp, xv, wv) for c in gemm.CONFIGS
                    for sp in (False, True) for xv in (False, True)
                    for wv in (False, True)}


def test_kernels_repeat_bit_for_bit(cuda):
    """The same call twice gives the same bits: split-K sums its partial
    tiles in a fixed order, with no atomics."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn((32, 3072), generator=gen, device=cuda)
    w = torch.randn((3072, 768), generator=gen, device=cuda)
    assert gemm.plan_gemm(32, 768, 3072).splits > 1
    assert torch.equal(matmul_tiled(x, w), matmul_tiled(x, w))
    xc = torch.randn((4, 7, 512), generator=gen, device=cuda)
    wc = torch.randn((3, 3, 512, 512), generator=gen, device=cuda)
    assert gemm.plan_gemm(14, 512, 4608).splits > 1
    a = conv2d_shard(xc, wc, pads=(1, 0, 1, 1))
    assert torch.equal(a, conv2d_shard(xc, wc, pads=(1, 0, 1, 1)))
    wd = torch.randn((3, 3, 1, 512), generator=gen, device=cuda)
    d = conv2d_shard(xc, wd, pads=(1, 0, 1, 1), depthwise=True)
    assert torch.equal(d, conv2d_shard(xc, wd, pads=(1, 0, 1, 1),
                                       depthwise=True))


def test_tile_loop_refuses_a_misaligned_vector_route(cuda, monkeypatch):
    """A 16-byte route on an operand that is not 16-byte aligned is
    refused by the launcher (cudaErrorInvalidValue) and raises; the
    counter does not move."""
    x = torch.randn(8, 65, device=cuda)[:, 1:]
    w = torch.randn(64, 64, device=cuda)
    monkeypatch.setattr(gemm, "x_vec", lambda *_: True)
    n0 = matmul_tiled.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        matmul_tiled(x, w)
    assert matmul_tiled.launches == n0
    monkeypatch.setattr(gemm, "x_vec", lambda *_: False)
    monkeypatch.setattr(gemm, "w_vec", lambda *_: True)
    with pytest.raises(RuntimeError, match="launch failed"):
        conv2d_shard(torch.randn(5, 5, 8, device=cuda),
                     torch.randn(3, 3, 8, 12, device=cuda)[..., 1:9])


@pytest.mark.parametrize("nodes", [2, 4])
@pytest.mark.parametrize("name", sorted(EDGE_MODELS))
def test_cuda_backend_matches_torch_backend(cuda, name, nodes):
    """Searched plans through the kernels on the card agree with the
    generic ATen path and the unpartitioned reference, ExecStats equal,
    and the kernels really ran."""
    g = EDGE_MODELS[name](**SMALL[name])
    ws = init_weights(g, torch.Generator().manual_seed(0), cuda)
    l0 = g.layers[0]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (l0.in_h, l0.in_w, l0.in_c)).astype(np.float32)).to(cuda)
    plan = plan_search(g, AnalyticEstimator(),
                       TorchTestbed(nodes=nodes, bandwidth_gbps=0.5)).plan
    n0 = (conv2d_shard.launches, matmul_tiled.launches)
    out_k, st_k = Session(g, ws, plan, nodes, ExecConfig()).run(x)
    torch.cuda.synchronize()
    ran = (conv2d_shard.launches - n0[0], matmul_tiled.launches - n0[1])
    out_t, st_t = Session(g, ws, plan, nodes,
                          ExecConfig(backend="torch")).run(x)
    ref = run_reference(g, ws, x)
    assert out_k.device.type == "cuda"
    assert _rel_err(out_k, out_t) < 1e-4
    assert _rel_err(out_k, ref) < 1e-4
    assert st_k == st_t
    assert ran[1] > 0
    assert (ran[0] > 0) == (name != "bert")


# ---------------------------------------------------------------------------
# attention kernels and the decode session
# ---------------------------------------------------------------------------

def _paged_pools(gen, dev, lh, hd, ps, n_pages, kv_len, window):
    """Random pools behind a scrambled table; the kernel's copy holds NaN
    in every page it must not read (past ceil(kv_len/ps), before the
    window's page), the plain version's copy zeros there."""
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


@pytest.mark.parametrize("ps", [1, 16])
@pytest.mark.parametrize("kv_len", [1, 15, 16, 17, 1000, 1500])
def test_decode_kernel_matches_plain(cuda, ps, kv_len):
    """OLMo-1B's per-node decode geometry (4 of 16 heads, hd 128) and 16
    heads at hd 64, windows that land mid-page; never reads a dead page."""
    gen = torch.Generator(device=cuda).manual_seed(kv_len * 7 + ps)
    n_pages = -(-1536 // ps)
    for lh, hd in ((4, 128), (16, 64)):
        q = torch.randn((lh, hd), generator=gen, device=cuda)
        for window in (None, 7, 100, 2000):
            kp, vp, kz, vz, table = _paged_pools(gen, cuda, lh, hd, ps,
                                                 n_pages, kv_len, window)
            n0 = flash_decode_paged.launches
            out = flash_decode_paged(q, kp, vp, table, kv_len, window=window)
            assert flash_decode_paged.launches == n0 + 1
            ref = flash_decode_paged_ref(q, kz, vz, table, kv_len,
                                         window=window)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(out).all()), (lh, window)
            assert _rel_err(out, ref) < 1e-5, (lh, hd, window)


def _split_edge_cases(lh, n_pages, ps):
    """(kv_len, window) at the split-KV grid's edges: kv_len 1, every
    split's first key and its neighbours, the capacity; no window, and a
    window that leaves only the last live split."""
    splits = fa_mod.decode_splits(lh, n_pages)
    keys = -(-n_pages // splits) * ps
    cap = n_pages * ps
    lens = {1, cap}
    for s in range(1, splits + 1):
        lens |= {s * keys - 1, s * keys, s * keys + 1}
    cases = []
    for kv_len in sorted(k for k in lens if 1 <= k <= cap):
        cases.append((kv_len, None))
        last = (kv_len - 1) // keys * keys        # first key of its split
        cases.append((kv_len, kv_len - last))
    return cases


@pytest.mark.parametrize("hd", [32, 64, 80, 128, 256])
@pytest.mark.parametrize("ps,n_pages", [(16, 32), (16, 256), (1, 100),
                                        (1, 2000)])
def test_decode_kernel_on_split_edges(cuda, hd, ps, n_pages):
    """The split-KV grid at its edges, for both block widths (runs of at
    most 64 keys take 8 warps, longer ones 32) and every 16-byte instance;
    NaN in every page it must not read; one launch a call."""
    lh = 4
    gen = torch.Generator(device=cuda).manual_seed(hd * 1000 + n_pages + ps)
    q = torch.randn((lh, hd), generator=gen, device=cuda)
    for kv_len, window in _split_edge_cases(lh, n_pages, ps):
        kp, vp, kz, vz, table = _paged_pools(gen, cuda, lh, hd, ps, n_pages,
                                             kv_len, window)
        n0 = flash_decode_paged.launches
        out = flash_decode_paged(q, kp, vp, table, kv_len, window=window)
        assert flash_decode_paged.launches == n0 + 1
        ref = flash_decode_paged_ref(q, kz, vz, table, kv_len, window=window)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out).all()), (kv_len, window)
        assert _rel_err(out, ref) < 1e-5, (kv_len, window)


@pytest.mark.parametrize("hd,offset", [(33, 0), (128, 1), (256, 2)])
def test_decode_kernel_on_the_4_byte_route(cuda, hd, offset):
    """An odd head dim, and pools that start off 16 bytes: the kernel reads
    4 bytes a lane."""
    lh, ps, n_pages = 3, 16, 40
    gen = torch.Generator(device=cuda).manual_seed(hd + offset)
    q = torch.randn((lh, hd), generator=gen, device=cuda)
    n = lh * n_pages * ps * hd

    def pool():
        base = torch.randn(n + offset, generator=gen, device=cuda)
        return base[offset:].view(lh, n_pages, ps, hd)
    kp, vp = pool(), pool()
    assert not fa_mod.decode_vec(hd, kp, vp)
    table = torch.randperm(n_pages, generator=gen, device=cuda).int()
    for kv_len, window in ((1, None), (333, None), (640, 50), (200, 17)):
        out = flash_decode_paged(q, kp, vp, table, kv_len, window=window)
        ref = flash_decode_paged_ref(q, kp, vp, table, kv_len, window=window)
        torch.cuda.synchronize()
        assert _rel_err(out, ref) < 1e-5, (kv_len, window)


def test_decode_kernel_repeats_bit_for_bit_and_under_graph_replay(cuda):
    """The merge runs in a fixed order with no atomics: two calls give the
    same bits, and so does a replay of a captured CUDA graph (one launch a
    call, no host state)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    lh, hd, ps, n_pages, kv_len = 4, 128, 16, 32, 300
    q = torch.randn((lh, hd), generator=gen, device=cuda)
    kp, vp, _, _, table = _paged_pools(gen, cuda, lh, hd, ps, n_pages,
                                       kv_len, None)
    first = flash_decode_paged(q, kp, vp, table, kv_len)
    assert torch.equal(first, flash_decode_paged(q, kp, vp, table, kv_len))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_decode_paged(q, kp, vp, table, kv_len)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n0 = flash_decode_paged.launches
    with torch.cuda.graph(graph):
        captured = flash_decode_paged(q, kp, vp, table, kv_len)
    assert flash_decode_paged.launches == n0 + 1
    captured.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)


def test_decode_launch_shape_fits_one_wave(cuda):
    """At the main path's shape (4 heads, 32 pages of 16 keys, hd 128):
    at least 32 blocks, every head's cluster resident at once (the
    kernel's occupancy entry), and one round of a block covers its split."""
    import ctypes
    lh, n_pages, ps, hd = 4, 32, 16, 128
    splits = fa_mod.decode_splits(lh, n_pages)
    warps = fa_mod.decode_warps(n_pages, ps, splits)
    info = (ctypes.c_int * 4)()
    rc = build.load("flash_decode_paged").flash_decode_paged_occupancy(
        lh, hd, 1, splits, warps, info)
    assert rc == 0
    threads, smem, clusters, rows = info
    assert lh * splits >= 32 and threads == warps * 32
    assert clusters >= lh
    assert rows >= -(-n_pages // splits) * ps


FLASH_CASES = [
    # B, H, KV, S, hd, causal, window, dtype, tol
    (1, 16, 16, 512, 128, True, None, torch.float32, 1e-4),
    (1, 8, 2, 300, 128, True, 100, torch.float32, 1e-4),
    (2, 4, 4, 257, 64, False, None, torch.float32, 1e-4),
    (1, 4, 4, 200, 32, False, 50, torch.float32, 1e-4),
    (1, 2, 1, 700, 256, True, None, torch.float32, 1e-4),
    (1, 8, 2, 384, 128, True, None, torch.bfloat16, 2e-2),
    (1, 4, 4, 100, 64, False, None, torch.bfloat16, 2e-2),
    # head dims off the mma depth (8 for 3xTF32, 16 for bf16), both dtypes
    *[(1, 4, 2, 130, hd, True, None, dt, tol) for hd in (16, 40, 80, 96, 256)
      for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2))],
    # odd head dims: 4-byte f32 copies, plain 2-byte bf16 loads, and a
    # 4-byte bf16 route (hd 36: 72-byte rows)
    (1, 2, 2, 77, 33, True, None, torch.float32, 1e-4),
    (1, 2, 2, 77, 33, False, None, torch.bfloat16, 2e-2),
    (1, 2, 2, 77, 36, True, None, torch.bfloat16, 2e-2),
    (1, 2, 1, 50, 1, True, None, torch.float32, 1e-4),
    (1, 2, 1, 50, 3, False, None, torch.bfloat16, 2e-2),
    # S around the 64-row q tile and the 32- and 64-key stages
    *[(1, 2, 2, S, hd, causal, None, dt, tol)
      for S in (1, 31, 33, 63, 64, 65, 127, 129) for causal in (True, False)
      for hd, dt, tol in ((128, torch.float32, 1e-4),
                          (64, torch.bfloat16, 2e-2))],
    # a one-key window: each row sees only itself
    (1, 4, 4, 200, 64, True, 1, torch.float32, 1e-4),
    (1, 4, 4, 200, 128, False, 1, torch.bfloat16, 2e-2),
    # GQA with H / KV = 8
    (1, 16, 2, 300, 128, True, None, torch.float32, 1e-4),
    (1, 16, 2, 300, 128, True, 64, torch.bfloat16, 2e-2),
    # f32 at hd 65-128, causal, on a grid of two waves or more of 128-row
    # blocks: two m-tiles a warp (the small causal grids above take one)
    (1, 128, 16, 640, 96, True, None, torch.float32, 1e-4),
    (2, 64, 8, 640, 128, True, None, torch.float32, 1e-4),
]


@pytest.mark.parametrize("B,H,KV,S,hd,causal,window,dtype,tol", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, B, H, KV, S, hd, causal,
                                              window, dtype, tol):
    """GQA by index, causal/window tile skips, unaligned S (keys at or past
    S masked in the kernel), hd 32..256, f32 and bf16 (f32 accumulation;
    bf16 at the reference's 2e-2)."""
    gen = torch.Generator(device=cuda).manual_seed(S + hd)
    q = torch.randn((B, H, S, hd), generator=gen, device=cuda).to(dtype)
    k = torch.randn((B, KV, S, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, KV, S, hd), generator=gen, device=cuda).to(dtype)
    n0 = flash_attention_bh.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attention_bh.launches == n0 + 1
    assert out.dtype == dtype
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _rel_err(out.float(), ref.float()) < tol
    if KV == H:
        bh = flash_attention_bh(q[0], k[0], v[0], causal=causal,
                                window=window)
        assert _rel_err(bh.float(), out[0].float()) < tol


def test_flash_attention_f32_holds_1e4_on_peaked_scores(cuda):
    """q and k scaled by 8 make the softmax sharply peaked: a score error
    of TF32's size (about three digits) moves the output past 1e-4 of its
    scale, so the case tells the 3xTF32 route from a TF32 shortcut.  The
    second half checks that a TF32 product indeed misses here."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    B, H, S, hd = 1, 8, 512, 128
    q = 8 * torch.randn((B, H, S, hd), generator=gen, device=cuda)
    k = 8 * torch.randn((B, H, S, hd), generator=gen, device=cuda)
    v = torch.randn((B, H, S, hd), generator=gen, device=cuda)
    for causal in (True, False):
        out = ops.flash_attention(q, k, v, causal=causal)
        ref = flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert _rel_err(out, ref) < 1e-4, causal
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = flash_attention_ref(q, k, v, causal=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert _rel_err(tf32, flash_attention_ref(q, k, v, causal=True)) > 1e-4


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("scale", [-0.3, 0.0, 1e-3, 2.0])
def test_flash_attention_bh_takes_any_scale(cuda, dtype, tol, scale):
    """The kernel folds |scale| log2(e) into one multiply-add and negates
    the q tile for a negative scale; a zero scale weighs the unmasked keys
    evenly and the masked ones not at all."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn((6, 130, 64), generator=gen,
                           device=cuda).to(dtype) for _ in range(3))
    for causal, window in ((True, None), (False, 40), (True, 7)):
        out = flash_attention_bh(q, k, v, causal=causal, window=window,
                                 scale=scale)
        ref = flash_attention_ref(q[None], k[None], v[None], causal=causal,
                                  window=window, scale=scale)[0]
        torch.cuda.synchronize()
        assert _rel_err(out.float(), ref.float()) < tol, (causal, window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_repeats_bit_for_bit_and_under_graph_replay(
        cuda, dtype):
    """Two calls on the same inputs give the same bits (no atomics, a
    fixed order of sums), and so does a replay of a captured CUDA graph."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((1, 8, 333, 128), generator=gen, device=cuda).to(dtype)
    k = torch.randn((1, 2, 333, 128), generator=gen, device=cuda).to(dtype)
    v = torch.randn((1, 2, 333, 128), generator=gen, device=cuda).to(dtype)
    first = ops.flash_attention(q, k, v, causal=True, window=100)
    assert torch.equal(first, ops.flash_attention(q, k, v, causal=True,
                                                  window=100))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.flash_attention(q, k, v, causal=True, window=100)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ops.flash_attention(q, k, v, causal=True, window=100)
    captured.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)


@pytest.mark.parametrize("dtype,offset", [(torch.float32, 1),
                                          (torch.float32, 2),
                                          (torch.bfloat16, 1),
                                          (torch.bfloat16, 2)])
def test_flash_attention_on_bases_off_16_bytes(cuda, dtype, offset):
    """Operands that start `offset` elements into their storage: the 16-byte
    copies give way to 4-byte copies (f32, bf16 at 4-byte bases) or plain
    loads (bf16 at 2-byte bases)."""
    gen = torch.Generator(device=cuda).manual_seed(offset)
    shape = (1, 4, 150, 64)
    n = 4 * 150 * 64

    def view():
        base = torch.randn(n + offset, generator=gen, device=cuda).to(dtype)
        return base[offset:].view(shape)
    q, k, v = view(), view(), view()
    assert q.data_ptr() % 16 != 0
    out = ops.flash_attention(q, k, v, causal=True)
    ref = flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert _rel_err(out.float(), ref.float()) < tol


def test_attention_wrappers_raise_on_operands_the_kernels_do_not_take(cuda):
    q = torch.randn(4, 64, device=cuda)
    kp = torch.randn(4, 8, 16, 64, device=cuda)
    table = torch.arange(8, device=cuda, dtype=torch.int32)
    with pytest.raises(TypeError, match="page table"):
        flash_decode_paged(q, kp, kp, np.arange(8, dtype=np.int32), 20)
    with pytest.raises(TypeError, match="page table"):
        flash_decode_paged(q, kp, kp, table.long(), 20)
    with pytest.raises(TypeError):
        flash_decode_paged(q.double(), kp.double(), kp.double(), table, 20)
    with pytest.raises(RuntimeError, match="contiguous"):
        flash_decode_paged(torch.randn(64, 4, device=cuda).t(), kp, kp,
                           table, 20)
    x = torch.randn(1, 2, 32, 64, device=cuda)
    with pytest.raises(TypeError):
        ops.flash_attention(x.half(), x.half(), x.half())
    with pytest.raises(RuntimeError, match="contiguous"):
        ops.flash_attention(x.transpose(2, 3), x.transpose(2, 3),
                            x.transpose(2, 3))
    with pytest.raises(RuntimeError, match="hd <="):
        ops.flash_attention(*(torch.randn(1, 1, 8, 300, device=cuda),) * 3)


def test_decode_session_on_the_card_matches_reference_decode(cuda):
    """The reference test size (tests/test_decode.py): a searched
    head-sharded plan through the paged decode kernel, token for token
    against the card's reference_decode and the plain backend; the kernel
    launches once per step for every node that owns heads."""
    spec = TransformerSpec(n_layers=2, d_model=256, n_heads=8, d_ff=1024,
                           vocab=64)
    prompt, n_new = [3, 17, 42, 7], 5
    w = init_transformer(spec, seed=1, device=cuda)
    ref_toks, ref_lg = reference_decode(spec, w, prompt, n_new)
    tb = TorchTestbed(nodes=4, bandwidth_gbps=5.0, link_latency_us=1.0)
    plan = plan_decode(spec, 2048, 4, tb=tb).plan
    n0 = flash_decode_paged.launches
    sess = DecodeSession(spec, w, plan, 4, ExecConfig(), page_size=4,
                         capacity=32)
    toks, lg = greedy_decode(sess, prompt, n_new)
    per_step = sum(sum(1 for h in hs if h) for hs in sess.head_split)
    assert flash_decode_paged.launches - n0 == \
        per_step * (len(prompt) + n_new)
    plain = DecodeSession(spec, w, plan, 4, ExecConfig(backend="torch"),
                          page_size=4, capacity=32)
    toks_t, lg_t = greedy_decode(plain, prompt, n_new)
    assert lg.device.type == "cuda"
    assert toks == ref_toks == toks_t
    assert _rel_err(lg, ref_lg) < 1e-4
    assert _rel_err(lg, lg_t) < 1e-4


# ---------------------------------------------------------------------------
# captured programs: segment programs and the decode step
# ---------------------------------------------------------------------------

def _rn_rep():
    """tests/test_engine.py's rn_rep chain (resnet18's stem and max pool at
    width 32, then two identical 3x3 blocks) under an InH plan: its
    interior cells share a program within one run."""
    g = chain("rn_prefix", resnet18(width=32).layers[:2], drop_edges=True)
    layers = list(g.layers)
    for tag in ("x", "y"):
        layers.append(LayerSpec(f"{tag}a", ConvT.CONV, 8, 8, 64, 64, 3, 1,
                                1))
    g = chain("rn_rep", layers)
    return g, fixed_plan(g, Scheme.INH)


def _mobilenet_prefix():
    """MobileNet v1's first ten layers at 224x224 under a searched plan."""
    g = chain("mb_prefix", EDGE_MODELS["mobilenet"]().layers[:10])
    plan = plan_search(g, AnalyticEstimator(),
                       TorchTestbed(nodes=4, bandwidth_gbps=0.5)).plan
    return g, plan


def _launches():
    return (conv2d_shard.launches, matmul_tiled.launches)


@pytest.mark.parametrize("case", ["rn_rep", "mobilenet_prefix"])
def test_captured_session_run_is_bit_equal_to_eager(cuda, case):
    """Segment programs on the card, eager then captured then replayed:
    each run's output has the bits of ``jit_segments=False``, equal
    ExecStats, and the launch counters add exactly what the eager run
    adds.  rn_rep's interior cells share a program within a run, so a
    replay that overwrote an earlier cell's shard would show here."""
    g, plan = _rn_rep() if case == "rn_rep" else _mobilenet_prefix()
    ws = init_weights(g, torch.Generator().manual_seed(4), cuda)
    l0 = g.layers[0]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (l0.in_h, l0.in_w, l0.in_c)).astype(np.float32)).to(cuda)
    n0 = _launches()
    eager, st_e = Session(g, ws, plan, 4,
                          ExecConfig(jit_segments=False)).run(x)
    torch.cuda.synchronize()
    want = tuple(b - a for a, b in zip(n0, _launches()))
    assert want[0] > 0
    clear_segment_cache()
    sess = Session(g, ws, plan, 4)
    outs = []
    for run in range(3):
        n0 = _launches()
        out, st = sess.run(x)
        torch.cuda.synchronize()
        assert tuple(b - a for a, b in zip(n0, _launches())) == want, run
        assert st == st_e
        outs.append(out)
        if run == 0 and case == "rn_rep":
            assert segment_cache_info().hits > 0
    info = segment_cache_info()
    assert info.misses == info.currsize
    for out in outs:
        assert torch.equal(out, eager)
    assert _rel_err(eager, run_reference(g, ws, x)) < 1e-4
    clear_segment_cache()


def test_a_graph_program_counts_replays_and_not_the_capture(cuda):
    """A GraphProgram around one kernel call: the eager call and each
    replay count one launch, the capture none, and a replay reads the
    input tensor as it stands at the call."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn((16, 64), generator=gen, device=cuda)
    w = torch.randn((64, 32), generator=gen, device=cuda)
    prog = GraphProgram(lambda a: matmul_tiled(a, w), x)
    counts = []
    for step in range(4):
        if step % 2:   # refilled in place, or copied in from an argument
            x.copy_(torch.randn((16, 64), generator=gen, device=cuda))
            arg = x
        else:
            arg = torch.randn((16, 64), generator=gen, device=cuda)
        n0 = matmul_tiled.launches
        out = prog(arg)
        counts.append(matmul_tiled.launches - n0)
        assert torch.equal(out, matmul_tiled(arg, w)), step
    assert counts == [1, 1, 1, 1]
    assert prog.graph is not None and prog.launches == ((matmul_tiled, 1),)


def test_the_collector_waits_out_a_capture(cuda):
    """Captured programs dropped inside reference cycles (a mesh stage
    program's body holds its program) are freed by Python's cyclic
    collector; one that ran during a later capture would free their
    graphs inside it and invalidate it.  The collector is paused for
    the length of each capture, switched back on after it, and frees
    those graphs between captures."""
    import gc
    import weakref

    seen = []

    def body(t):
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
        return t + 1.0

    class Holder:
        pass

    x = torch.ones(64, device=cuda)
    h = Holder()
    h.prog = GraphProgram(lambda t, h=h: t * 2.0, x.clone())
    h.prog(x)
    h.prog(x)                                    # captured
    dropped = weakref.ref(h.prog)
    del h
    assert gc.isenabled() and dropped() is not None
    prog = GraphProgram(body, x.clone())
    for _ in range(3):
        out = prog(x)
    assert seen == [False] and gc.isenabled()
    assert prog.graph is not None and torch.equal(out, x + 1.0)
    gc.collect()
    assert dropped() is None


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_captured_greedy_decode_is_bit_equal_to_the_eager_body(cuda,
                                                                backend):
    """A small spec on 4 nodes: the captured step (eager first, captured
    second, replayed after) gives the tokens and logits of the eager body
    bit for bit, the tokens of the card's reference_decode, and counts one
    kernel launch per step for every node that owns heads."""
    spec = TransformerSpec(n_layers=2, d_model=256, n_heads=8, d_ff=1024,
                           vocab=64)
    prompt, n_new = [3, 17, 42, 7, 11, 5], 9
    w = init_transformer(spec, seed=2, device=cuda)
    tb = TorchTestbed(nodes=4, bandwidth_gbps=5.0, link_latency_us=1.0)
    plan = plan_decode(spec, 2048, 4, tb=tb).plan
    kw = dict(page_size=4, capacity=32)
    graphed = DecodeSession(spec, w, plan, 4, ExecConfig(backend=backend),
                            **kw)
    assert isinstance(graphed._step_fn, GraphProgram)
    n0 = flash_decode_paged.launches
    toks, lg = greedy_decode(graphed, prompt, n_new)
    torch.cuda.synchronize()
    per_step = sum(sum(1 for h in hs if h) for hs in graphed.head_split)
    ran = flash_decode_paged.launches - n0
    assert ran == (per_step * (len(prompt) + n_new)
                   if backend == "cuda" else 0)
    assert graphed._step_fn.graph is not None
    eager = DecodeSession(spec, w, plan, 4, ExecConfig(backend=backend),
                          **kw)
    eager._step_fn = eager._local_step
    toks_e, lg_e = greedy_decode(eager, prompt, n_new)
    assert toks == toks_e
    assert torch.equal(lg, lg_e)
    for i in range(spec.n_layers):
        for n in range(4):
            for a, b in zip(graphed.cache.pages(i, n),
                            eager.cache.pages(i, n)):
                assert torch.equal(a, b)
    ref_toks, ref_lg = reference_decode(spec, w, prompt, n_new)
    assert toks == ref_toks
    assert _rel_err(lg, ref_lg) < 1e-4


@pytest.mark.parametrize("window", [None, 7, 100])
@pytest.mark.parametrize("ps", [1, 16])
def test_decode_kernel_pointer_path_is_bit_equal_to_by_value(cuda, ps,
                                                             window):
    """kv_len read from a device int32 gives the by-value call's bits over
    a sweep of lengths, never reading a dead page (NaN there), and one
    captured launch replayed at each length gives the same bits again."""
    gen = torch.Generator(device=cuda).manual_seed(ps * 3 + (window or 0))
    lh, hd, n_pages = 4, 128, -(-512 // ps)
    q = torch.randn((lh, hd), generator=gen, device=cuda)
    length = torch.zeros((1,), dtype=torch.int32, device=cuda)
    for kv_len in (1, ps - 1, ps, ps + 1, 100, 333, 511, 512):
        if kv_len < 1:
            continue
        kp, vp, _, _, table = _paged_pools(gen, cuda, lh, hd, ps, n_pages,
                                           kv_len, window)
        length.fill_(kv_len)
        by_value = flash_decode_paged(q, kp, vp, table, kv_len,
                                      window=window)
        by_ptr = flash_decode_paged(q, kp, vp, table, length, window=window)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(by_ptr).all()), kv_len
        assert torch.equal(by_value, by_ptr), kv_len
    # one capture at a short length, replayed at every length
    kp = torch.randn((lh, n_pages, ps, hd), generator=gen, device=cuda)
    vp = torch.randn((lh, n_pages, ps, hd), generator=gen, device=cuda)
    length.fill_(1)
    prog = GraphProgram(
        lambda n: flash_decode_paged(q, kp, vp, table, n, window=window),
        length)
    for kv_len in (1, 2, 17, 300, 512):
        length.fill_(kv_len)
        got = prog(length).clone()
        assert torch.equal(got, flash_decode_paged(q, kp, vp, table, kv_len,
                                                   window=window)), kv_len
    assert prog.graph is not None


# ---------------------------------------------------------------------------
# the mesh executor: a stream a node, one captured graph a stage
# ---------------------------------------------------------------------------

def _smoke():
    """chip_smoke.py as a module, for its launch records of a plan."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mesh_case(case, dev):
    g, plan = _rn_rep() if case == "rn_rep" else _mobilenet_prefix()
    ws = init_weights(g, torch.Generator().manual_seed(5), dev)
    l0 = g.layers[0]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (l0.in_h, l0.in_w, l0.in_c)).astype(np.float32)).to(dev)
    return g, plan, ws, x


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("nodes", [2, 4])
@pytest.mark.parametrize("case", ["rn_rep", "mobilenet_prefix"])
def test_mesh_session_run_is_bit_equal_across_capture_and_replay(
        cuda, case, nodes, overlap):
    """The mesh's eager, capturing and replaying runs give the same bits,
    within 1e-4 of the local executor, its ExecStats and no fault; each
    run launches the kernels the plan's mesh records call for.  rn_rep's
    repeated blocks would show a stage output overwritten by a replay."""
    g, plan, ws, x = _mesh_case(case, cuda)
    local, st_l = Session(g, ws, plan, nodes,
                          ExecConfig(jit_segments=False)).run(x)
    want = _smoke().mesh_kernel_records(g, plan, nodes, overlap)
    assert want[0] > 0
    clear_mesh_program_cache()
    sess = Session(g, ws, plan, nodes, ExecConfig(executor="mesh",
                                                  overlap=overlap))
    assert len(sess.mesh.streams) == nodes
    outs = []
    for run in range(3):
        n0 = _launches()
        out, st = sess.run(x)
        torch.cuda.synchronize()
        assert tuple(b - a for a, b in zip(n0, _launches())) == want, run
        assert st == st_l and st.failure_count == 0
        outs.append(out)
    for out in outs:
        assert torch.equal(out, outs[0])
    assert _rel_err(outs[0], local) < 1e-4
    info = mesh_program_cache_info()
    assert info.hits == 2 * info.misses == 2 * info.currsize
    clear_mesh_program_cache()


def test_a_mesh_stage_graph_holds_every_node_stream(cuda, monkeypatch):
    """The capture of a 4-node mesh run records each node's records on
    that node's stream (fork) and ends (a stream left unjoined fails
    ``capture_end``); every stage output lies in its graph's own pool."""
    g, plan, ws, x = _mesh_case("rn_rep", cuda)
    clear_mesh_program_cache()
    sess = Session(g, ws, plan, 4, ExecConfig(executor="mesh"))
    seen = []
    run_records = mesh_exec._run_records

    def spy(recs, weights, xs, backend):
        seen.append((torch.cuda.current_stream().cuda_stream,
                     torch.cuda.is_current_stream_capturing()))
        return run_records(recs, weights, xs, backend)
    monkeypatch.setattr(mesh_exec, "_run_records", spy)
    sess.run(x)
    seen.clear()
    out, _ = sess.run(x)
    torch.cuda.synchronize()
    assert {s for s, capturing in seen if capturing} == \
        {s.cuda_stream for s in sess.mesh.streams}
    segments = torch.cuda.memory_snapshot()

    def pool_of(t):
        p = t.data_ptr()
        return next(tuple(seg["segment_pool_id"]) for seg in segments
                    if seg["address"] <= p < seg["address"]
                    + seg["total_size"])

    def tensors(obj):
        if isinstance(obj, torch.Tensor):
            return [obj] if obj.numel() else []
        return [t for o in obj for t in tensors(o)]
    progs = [p for p in mesh_exec._PROGRAMS.values() if p.graph is not None]
    assert progs and all(p.graph.graph is not None for p in progs)
    for prog in progs:
        pool = tuple(prog.graph.graph.pool())
        for t in tensors(prog.graph.out):
            assert pool_of(t) == pool
    assert _rel_err(out, run_reference(g, ws, x)) < 1e-4
    clear_mesh_program_cache()


def test_instrumented_mesh_stages_time_every_node(cuda):
    """instrument=True on the eager, capturing and replaying runs: every
    compute stage carries each of the 4 nodes' completion (timing events
    on its stream, inside the stage's graph once captured), within the
    stage's wall, and the outputs keep their bits."""
    g, plan, ws, x = _mesh_case("mobilenet_prefix", cuda)
    clear_mesh_program_cache()
    sess = Session(g, ws, plan, 4, ExecConfig(executor="mesh",
                                              instrument=True, overlap=False))
    outs = []
    for run in range(3):
        out, st = sess.run(x)
        outs.append(out)
        comp = [t for t in st.stage_times if t.kind == "compute"]
        assert comp and {t.kind for t in st.stage_times} == \
            {"compute", "sync"}
        for t in comp:
            assert len(t.device_done_s) == 4
            assert all(0.0 < d <= t.wall_s for d in t.device_done_s), \
                (run, t)
        assert st.to_occupancy().dev_occupancy_s > 0.0
    assert all(p.graph.graph is not None
               for p in mesh_exec._PROGRAMS.values() if p.graph is not None)
    for out in outs:
        assert torch.equal(out, outs[0])
    assert _rel_err(outs[0], run_reference(g, ws, x)) < 1e-4
    clear_mesh_program_cache()


def test_mesh_stage_timeout_fires_in_a_worker_on_the_callers_stream(
        cuda, monkeypatch):
    """An unmeetable stage_timeout_s raises StageTimeoutError from the
    watchdog; with a generous one every stage forks from the caller's
    stream inside the worker thread and the run completes."""
    g, plan, ws, x = _mesh_case("rn_rep", cuda)
    clear_mesh_program_cache()
    forks = []
    run = NodesMesh.run

    def spy(self, *phases, marks=None):
        forks.append((threading.current_thread().name,
                      torch.cuda.current_stream()))
        return run(self, *phases, marks=marks)
    monkeypatch.setattr(NodesMesh, "run", spy)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        with pytest.raises(StageTimeoutError, match="first call"):
            Session(g, ws, plan, 4, ExecConfig(
                executor="mesh", stage_timeout_s=1e-4)).run(x)
        assert torch.cuda.current_stream() == side
        for th in threading.enumerate():
            if th.name.startswith("mesh-stage:"):
                th.join(120)
                assert not th.is_alive()
        # first calls only: each runs eagerly, forking from the stream
        # the worker took over (a capture forks from its own stream)
        clear_mesh_program_cache()
        forks.clear()
        out, st = Session(g, ws, plan, 4, ExecConfig(
            executor="mesh", stage_timeout_s=300.0)).run(x)
    torch.cuda.synchronize()
    assert forks and all(name.startswith("mesh-stage:") and s == side
                         for name, s in forks)
    assert st.failure_count == 0
    assert _rel_err(out, run_reference(g, ws, x)) < 1e-4
    clear_mesh_program_cache()


def test_mesh_timeout_during_a_capture_falls_back_after_the_worker(
        cuda, monkeypatch):
    """stage_timeout_s expires while the first stage's second call
    captures its graph (held up inside the capture), with
    fallback='local': the fallback waits for the abandoned worker to end
    the capture, then the local executor runs on the card: the local
    run's bits, one timeout and one fallback counted."""
    g, plan, ws, x = _mesh_case("rn_rep", cuda)
    clear_mesh_program_cache()
    Session(g, ws, plan, 4, ExecConfig(executor="mesh")).run(x)  # eager
    torch.cuda.synchronize()
    run = NodesMesh.run
    slowed = []

    def slow(self, *phases, marks=None):
        if torch.cuda.is_current_stream_capturing() and not slowed:
            slowed.append(threading.current_thread().name)
            time.sleep(0.5)
        return run(self, *phases, marks=marks)
    monkeypatch.setattr(NodesMesh, "run", slow)
    out, st = Session(g, ws, plan, 4, ExecConfig(
        executor="mesh", stage_timeout_s=0.1, fallback="local")).run(x)
    torch.cuda.synchronize()
    assert slowed and slowed[0].startswith("mesh-stage:")
    assert not any(th.name.startswith("mesh-stage:")
                   for th in threading.enumerate())
    assert st.timeouts == 1 and st.fallbacks == 1 and st.retries == 0
    local, _ = Session(g, ws, plan, 4, ExecConfig()).run(x)
    assert torch.equal(out, local)
    assert _rel_err(out, run_reference(g, ws, x)) < 1e-4
    clear_mesh_program_cache()


@pytest.mark.parametrize("overlap", [True, False])
def test_traced_replayed_mesh_run_is_bit_equal_with_spans_one_to_one(
        cuda, overlap):
    """Stage programs captured with tracing off, then replayed under a
    tracer: the replay's output and ExecStats equal the untraced
    replay's, and the control-track stage spans mirror its stage_times
    one to one, each compute stage with a device span per node (the
    spans are recorded on the host around the replay, not in the
    graph)."""
    g, plan, ws, x = _mesh_case("mobilenet_prefix", cuda)
    clear_mesh_program_cache()
    sess = Session(g, ws, plan, 4, ExecConfig(executor="mesh",
                                              instrument=True,
                                              overlap=overlap))
    for _ in range(3):                  # eager, capture, replay
        ref, st_ref = sess.run(x)
    torch.cuda.synchronize()
    assert all(p.graph.graph is not None
               for p in mesh_exec._PROGRAMS.values() if p.graph is not None)
    tr = obs.set_tracer(obs.Tracer())
    try:
        out, st = sess.run(x)
        torch.cuda.synchronize()
    finally:
        obs.set_tracer(None)
    assert torch.equal(out, ref)
    assert st == st_ref and st.failure_count == 0
    spans = tr.spans(cat=obs.STAGE_CAT, track=obs.CONTROL_TRACK)
    assert [(s["name"], s["args"]["kind"]) for s in spans] == \
        [(t.label, t.kind) for t in st.stage_times]
    for s, t in zip(spans, st.stage_times):
        assert s["dur"] == pytest.approx(t.wall_s * 1e6)
    dev = tr.spans(cat="device")
    assert len(dev) == sum(len(t.device_done_s) for t in st.stage_times)
    assert {s["track"] for s in dev} == {obs.device_track(d)
                                         for d in range(4)}
    assert _rel_err(out, run_reference(g, ws, x)) < 1e-4
    clear_mesh_program_cache()


def test_mesh_retry_on_the_card(cuda):
    """A fault injected once before one stage's dispatch, with
    stage_retries=1: one retry counted, a stage_retry record in the
    flight ring and a retry instant on the control track, and the output
    the clean run's bits."""
    from repro_torch.runtime.mesh_exec import run_partitioned_mesh
    g, plan, ws, x = _mesh_case("rn_rep", cuda)
    clear_mesh_program_cache()
    ref, st_ref = run_partitioned_mesh(g, ws, x, plan, 4)
    torch.cuda.synchronize()
    seen = []

    def hook(kind, label, attempt):
        seen.append((kind, label, attempt))
        if len(seen) == 2:
            raise OSError(f"injected fault at {label}")

    obs.get_flight().clear()
    tr = obs.set_tracer(obs.Tracer())
    try:
        out, st = run_partitioned_mesh(g, ws, x, plan, 4, stage_retries=1,
                                       fault_hook=hook)
        torch.cuda.synchronize()
    finally:
        obs.set_tracer(None)
    label = seen[1][1]
    assert seen[2] == (seen[1][0], label, 1)
    assert st.retries == 1 and st.timeouts == 0 and st.fallbacks == 0
    assert st == st_ref
    assert torch.equal(out, ref)
    ring = [(e["kind"], e.get("label")) for e in obs.get_flight().events()]
    assert ("stage_retry", label) in ring
    assert [r["name"] for r in tr._records if r["ph"] == "i"] == \
        [f"retry:{label}"]
    obs.get_flight().clear()
    clear_mesh_program_cache()


@pytest.mark.parametrize("kind", ["searched", "mixed"])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_captured_mesh_decode_is_bit_equal_to_its_eager_body(cuda, backend,
                                                            kind):
    """The mesh decode step on 4 node streams, captured as one graph: its
    tokens, logits and pools equal its eager body's bit for bit, the local
    session's tokens and (within 1e-4) logits and pools, and it launches
    the decode kernel once a step for every node that holds heads (every
    node, in the mixed plan's replicated ATTN)."""
    spec = TransformerSpec(n_layers=2, d_model=256, n_heads=8, d_ff=1024,
                           vocab=64)
    prompt, n_new = [3, 17, 42, 7, 11, 5], 9
    w = init_transformer(spec, seed=2, device=cuda)
    tb = TorchTestbed(nodes=4, bandwidth_gbps=5.0, link_latency_us=1.0)
    plan = plan_decode(spec, 2048, 4, tb=tb).plan if kind == "searched" \
        else Plan(((Scheme.INH, Mode.T), (Scheme.OUTC, Mode.T),
                   (Scheme.OUTC, Mode.T), (Scheme.INH, Mode.T)))
    kw = dict(page_size=4, capacity=32)

    def session(executor):
        return DecodeSession(spec, w, plan, 4, ExecConfig(
            backend=backend, executor=executor), **kw)
    graphed = session("mesh")
    assert isinstance(graphed._step_fn, GraphProgram)
    assert len(graphed.mesh.streams) == 4
    n0 = flash_decode_paged.launches
    toks, lg = greedy_decode(graphed, prompt, n_new)
    torch.cuda.synchronize()
    per_step = sum(sum(1 for h in hs if h) for hs in graphed.head_split)
    ran = flash_decode_paged.launches - n0
    assert ran == (per_step * (len(prompt) + n_new)
                   if backend == "cuda" else 0)
    assert graphed._step_fn.graph is not None
    eager = session("mesh")
    eager._step_fn = eager._mesh_step
    toks_e, lg_e = greedy_decode(eager, prompt, n_new)
    local = session("local")
    toks_l, lg_l = greedy_decode(local, prompt, n_new)
    assert toks == toks_e == toks_l
    assert torch.equal(lg, lg_e)
    assert _rel_err(lg, lg_l) < 1e-4
    for i in range(spec.n_layers):
        for n in range(4):
            for a, b, c in zip(graphed.cache.pages(i, n),
                               eager.cache.pages(i, n),
                               local.cache.pages(i, n)):
                assert torch.equal(a, b)
                assert _rel_err(a, c) < 1e-4
    ref_toks, ref_lg = reference_decode(spec, w, prompt, n_new)
    assert toks == ref_toks
    assert _rel_err(lg, ref_lg) < 1e-4


# ---------------------------------------------------------------------------
# the refinement loop on occupancy measured on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mobilenet", "resnet18"])
def test_refine_on_measured_card_occupancy(cuda, name):
    """``refine_with_simulator(occupancy_fn=...)`` where each tried plan
    runs on the mesh executor (eager, capturing, replayed; instrument=True,
    overlap=False) and the replayed run's occupancy is returned: every
    tried plan within 1e-4 of the ``backend="torch"`` run, no fault
    counted, and the frontier's extreme plans too."""
    from repro_torch.cluster import (Objective, OnlineCalibrator,
                                     cluster_pipeline_frontier, homogeneous,
                                     refine_with_simulator)
    g = EDGE_MODELS[name](**SMALL[name])
    ws = init_weights(g, torch.Generator().manual_seed(0), cuda)
    l0 = g.layers[0]
    x = torch.randn((l0.in_h, l0.in_w, l0.in_c),
                    generator=torch.Generator().manual_seed(1)).to(cuda)
    cl = homogeneous(4, bandwidth_gbps=0.5)
    tried = []

    def measure(plan):
        clear_mesh_program_cache()
        sess = Session(g, ws, plan, 4, ExecConfig(
            executor="mesh", overlap=False, instrument=True))
        outs = [sess.run(x) for _ in range(3)]
        ref, _ = Session(g, ws, plan, 4, ExecConfig(backend="torch")).run(x)
        for out, st in outs:
            assert st.failure_count == 0
            assert torch.equal(out, outs[0][0])
            assert _rel_err(out, ref) < 1e-4
        tried.append(plan)
        return outs[-1][1].to_occupancy()

    fr = cluster_pipeline_frontier(g, cl, prune_ub=False)
    cal = OnlineCalibrator(cl)
    rr = refine_with_simulator(g, cl, max_iters=3, frontier=fr,
                               occupancy_fn=measure, calibrator=cal)
    assert rr.report is None and rr.steps and tried
    assert all(s.dev_occupancy_s > 0.0 for s in rr.steps)
    assert all(h.trusted for h in cal.history)
    for scales in (dict(compute_scale=1e6), dict(sync_scale=1e6)):
        measure(fr.plan(fr.select(Objective.THROUGHPUT, **scales)))
    clear_mesh_program_cache()


# ---------------------------------------------------------------------------
# the GBDT cost estimator on the card
# ---------------------------------------------------------------------------

def _gbdt_toy(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, size=(n, 5))
    y = (np.sin(x[:, 0]) + 0.5 * x[:, 1] ** 2 + (x[:, 2] > 0) * x[:, 3]
         + 0.05 * rng.normal(size=n))
    return x, y


def _flat_equal(a, b) -> bool:
    return a.base_ == b.base_ and len(a.trees_) == len(b.trees_) and all(
        np.array_equal(p, q) for ta, tb in zip(a.trees_, b.trees_)
        for p, q in zip(ta.flat(), tb.flat()))


def test_gbdt_device_predict_bit_equals_cpu_predict(cuda):
    from repro_torch.gbdt import GBDTRegressor
    x, y = _gbdt_toy(3000, 0)
    cpu = GBDTRegressor(n_estimators=30, max_depth=7, device="cpu").fit(x, y)
    dev = GBDTRegressor.from_arrays(cpu.base_, cpu.learning_rate,
                                    [t.flat() for t in cpu.trees_],
                                    cpu.n_features_, device=cuda)
    xt, _ = _gbdt_toy(5000, 1)
    want = cpu.predict(xt)
    assert np.array_equal(dev.predict(xt), want)
    assert np.array_equal(dev.predict_reference(xt), want)
    assert np.array_equal(dev.predict(xt[:1]), want[:1])
    assert dev.predict(xt[:0]).shape == (0,)
    t = dev.predict(torch.from_numpy(xt).to(cuda))
    assert t.device.type == cuda.type
    assert np.array_equal(t.cpu().numpy(), want)
    for tree_c, tree_d in zip(cpu.trees_, dev.trees_):
        got = tree_d.predict(torch.from_numpy(xt).to(cuda)).cpu().numpy()
        assert np.array_equal(got, tree_c.predict(torch.from_numpy(xt))
                              .numpy())


def test_gbdt_device_fits_are_deterministic(cuda):
    """Two fits of the same data on the card give the same forest bit for
    bit (the histograms reduce by sort and segment, no atomics), its
    held-out error is the CPU fit's within 1%, and numpy-order node sums
    are the CPU's to the bit."""
    from repro_torch.gbdt import GBDTRegressor
    from repro_torch.gbdt.tree import segment_sums
    x, y = _gbdt_toy(20000, 2)
    kw = dict(n_estimators=20, max_depth=7, seed=3)
    a = GBDTRegressor(device=cuda, **kw).fit(x, y)
    b = GBDTRegressor(device=cuda, **kw).fit(x, y)
    assert _flat_equal(a, b)
    cpu = GBDTRegressor(device="cpu", **kw).fit(x, y)
    xt, yt = _gbdt_toy(4000, 4)
    rmse = [float(np.sqrt(np.mean((m.predict(xt) - yt) ** 2)))
            for m in (a, cpu)]
    assert abs(rmse[0] - rmse[1]) <= 0.01 * rmse[1], rmse
    v = torch.from_numpy(np.random.default_rng(5).normal(size=(40000, 2)))
    counts = [1, 7, 129, 8192, 8193, 20000, 3478]
    assert torch.equal(segment_sums(v.to(cuda), counts).cpu(),
                       segment_sums(v, counts))


def test_gbdt_default_device_is_the_card(cuda):
    from repro_torch.gbdt import GBDTRegressor, RegressionTree
    from repro_torch.sim import TraceConfig, train_estimators
    assert GBDTRegressor().device.type == "cuda"
    assert RegressionTree().device.type == "cuda"
    est = train_estimators(TraceConfig(n_samples=1500, seed=1),
                           gbdt_kwargs=dict(n_estimators=4, max_depth=4))
    for m in (est.i_model, est.s_model):
        assert m.device.type == "cuda"
        assert all(a.device.type == "cuda" for t in m.trees_
                   for a in t.arrays)


def test_gbdt_estimator_refuses_nothing_on_device_forests(cuda):
    """Scalar and batched calls, the batched and the scalar searches, the
    cluster estimator and the baselines all run on forests on the card
    and price exactly as the same forests on the CPU."""
    from repro_torch.cluster import (ClusterGBDTEstimator,
                                     cluster_plan_search, mixed_fast_slow)
    from repro_torch.core import (GBDTEstimator, baselines,
                                  plan_search_reference)
    from repro_torch.gbdt import GBDTRegressor
    from repro_torch.sim import hetero_trace_config, train_estimators
    est = train_estimators(hetero_trace_config(n_samples=3000, seed=0),
                           gbdt_kwargs=dict(n_estimators=12, max_depth=6))

    def on_cpu(m):
        return GBDTRegressor.from_arrays(m.base_, m.learning_rate,
                                         [t.flat() for t in m.trees_],
                                         m.n_features_, device="cpu")

    cpu = GBDTEstimator(on_cpu(est.i_model), on_cpu(est.s_model))
    cl = mixed_fast_slow(4)
    ce, ce_cpu = ClusterGBDTEstimator(est, cl), ClusterGBDTEstimator(cpu, cl)
    g = EDGE_MODELS["mobilenet"](**SMALL["mobilenet"])
    tb = cl.compat_testbed()
    for a, b in ((cluster_plan_search(g, cl, estimator=ce),
                  cluster_plan_search(g, cl, estimator=ce_cpu)),
                 (plan_search_reference(g, ce, tb),
                  plan_search_reference(g, ce_cpu, tb))):
        assert a.plan == b.plan and a.cost == b.cost
    layer = g.layers[1]
    assert ce.i_cost(layer, Scheme.INH, tb) == ce_cpu.i_cost(layer,
                                                             Scheme.INH, tb)
    sols = baselines.all_solutions(g, ce, tb)
    sols_cpu = baselines.all_solutions(g, ce_cpu, tb)
    assert {k: v[1] for k, v in sols.items()} == \
        {k: v[1] for k, v in sols_cpu.items()}


# ---------------------------------------------------------------------------
# the LM substrate: bf16 and grouped-query paged decode, models on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [64, 80, 128, 256])
@pytest.mark.parametrize("ps,kv_len", [(1, 37), (16, 17), (16, 1500)])
def test_decode_kernel_bf16_matches_plain(cuda, hd, ps, kv_len):
    """bf16 q and pools (hd 80: a row of ten 16-byte pieces; odd multiples
    take the 2-byte route below), f32 accumulation, bf16 out, within the
    reference's 2e-2 of scale; NaN in every page it must not read."""
    lh, n_pages = 8, -(-1536 // ps)
    gen = torch.Generator(device=cuda).manual_seed(hd + ps + kv_len)
    q = torch.randn((lh, hd), generator=gen, device=cuda).bfloat16()
    for window in (None, 7, 100):
        kp, vp, kz, vz, table = (t.bfloat16() if t.is_floating_point()
                                 else t for t in _paged_pools(
                                     gen, cuda, lh, hd, ps, n_pages, kv_len,
                                     window))
        out = flash_decode_paged(q, kp, vp, table, kv_len, window=window)
        ref = flash_decode_paged_ref(q, kz, vz, table, kv_len, window=window)
        torch.cuda.synchronize()
        assert out.dtype == torch.bfloat16
        assert bool(torch.isfinite(out).all()), window
        assert _rel_err(out, ref) < 2e-2, window


@pytest.mark.parametrize("hd,offset", [(36, 0), (128, 1)])
def test_decode_kernel_bf16_on_the_2_byte_route(cuda, hd, offset):
    lh, ps, n_pages = 4, 16, 20
    gen = torch.Generator(device=cuda).manual_seed(hd * 3 + offset)
    q = torch.randn((lh, hd), generator=gen, device=cuda).bfloat16()
    n = lh * n_pages * ps * hd

    def pool():
        base = torch.randn(n + offset, generator=gen, device=cuda).bfloat16()
        return base[offset:].view(lh, n_pages, ps, hd)
    kp, vp = pool(), pool()
    assert not fa_mod.decode_vec(hd, kp, vp)
    table = torch.randperm(n_pages, generator=gen, device=cuda).int()
    for kv_len, window in ((1, None), (200, None), (320, 33)):
        out = flash_decode_paged(q, kp, vp, table, kv_len, window=window)
        ref = flash_decode_paged_ref(q, kp, vp, table, kv_len, window=window)
        torch.cuda.synchronize()
        assert _rel_err(out, ref) < 2e-2, (kv_len, window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 2, 4, 8])
def test_decode_kernel_groups_equal_repeated_pools(cuda, dtype, groups):
    """``groups`` query rows read one pool row: bit-equal to the ungrouped
    call on pools repeated ``groups`` times (the same launch shape, the
    same sums), for the by-value and the device ``kv_len`` alike."""
    rows, ps, n_pages, hd = 4, 16, 64, 128
    gen = torch.Generator(device=cuda).manual_seed(groups)
    q = torch.randn((rows * groups, hd), generator=gen, device=cuda).to(dtype)
    kp = torch.randn((rows, n_pages, ps, hd), generator=gen,
                     device=cuda).to(dtype)
    vp = torch.randn_like(kp)
    table = torch.randperm(n_pages, generator=gen, device=cuda).int()
    kr, vr = (t.repeat_interleave(groups, dim=0) for t in (kp, vp))
    length = torch.zeros((1,), dtype=torch.int32, device=cuda)
    for kv_len, window in ((1, None), (300, None), (1024, 50)):
        length.fill_(kv_len)
        got = flash_decode_paged(q, kp, vp, table, kv_len, window=window,
                                 groups=groups)
        by_ptr = flash_decode_paged(q, kp, vp, table, length, window=window,
                                    groups=groups)
        want = flash_decode_paged(q, kr, vr, table, kv_len, window=window)
        plain = flash_decode_paged_ref(q, kp, vp, table, kv_len,
                                       window=window, groups=groups)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(by_ptr, got)
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        assert _rel_err(got, plain) < tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_device_kv_len_bit_equal(cuda, dtype):
    lh, ps, n_pages, hd = 16, 16, 32, 128
    gen = torch.Generator(device=cuda).manual_seed(31)
    q = torch.randn((lh, hd), generator=gen, device=cuda).to(dtype)
    kp = torch.randn((lh // 4, n_pages, ps, hd), generator=gen,
                     device=cuda).to(dtype)
    vp = torch.randn_like(kp)
    table = torch.arange(n_pages, dtype=torch.int32, device=cuda)
    length = torch.zeros((1,), dtype=torch.int32, device=cuda)
    for kv_len in (1, 16, 17, 500, 512):
        length.fill_(kv_len)
        a = flash_decode_paged(q, kp, vp, table, kv_len, groups=4)
        b = flash_decode_paged(q, kp, vp, table, length, groups=4)
        torch.cuda.synchronize()
        assert torch.equal(a, b), kv_len


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cap", [32, 10, 17])
def test_lm_cache_viewed_as_pools(cuda, dtype, cap):
    """A contiguous LM cache ``[B, KV, cap, hd]`` read in place through the
    identity table of ``models.attention.page_table`` (32 keys: pages of
    16; 10: one page of 10; 17: pages of 1), 32 query heads over 8 KV
    heads, against the plain version on the gathered, repeated keys."""
    from repro_torch.models.attention import page_size, page_table
    B, H, KV, hd = 4, 32, 8, 128
    gen = torch.Generator(device=cuda).manual_seed(cap)
    k = torch.randn((B, KV, cap, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn_like(k)
    q = torch.randn((B * H, hd), generator=gen, device=cuda).to(dtype)
    table = page_table(cap, cuda)
    ps = page_size(cap)
    pools = [t.view(B * KV, cap // ps, ps, hd) for t in (k, v)]
    for kv_len in (1, cap // 2, cap):
        out = flash_decode_paged(q, *pools, table, kv_len, groups=H // KV)
        kf = k[:, :, :kv_len].float().repeat_interleave(H // KV, dim=1)
        vf = v[:, :, :kv_len].float().repeat_interleave(H // KV, dim=1)
        s = torch.einsum("bhd,bhtd->bht", q.float().view(B, H, hd), kf) \
            / hd ** 0.5
        want = torch.einsum("bht,bhtd->bhd", torch.softmax(s, -1), vf)
        torch.cuda.synchronize()
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        assert _rel_err(out.view(B, H, hd), want) < tol, kv_len


@pytest.mark.parametrize("arch", ["llama3-8b", "whisper-small",
                                  "zamba2-1.2b", "deepseek-v2-236b"])
def test_lm_decode_on_the_card_matches_the_cpu(cuda, arch):
    """A reduced registry model on the card (f32, TF32 off) against the
    same weights on the CPU (plain versions): forward and ten decode steps
    within 1e-4 of scale; the attention kernels launched where the model
    has GQA self-attention."""
    import copy
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import Model
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(cuda)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 10)))
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["audio_embeds"] = torch.from_numpy(
            (rng.standard_normal((2, cfg.enc_seq, cfg.d_model)) * 0.02)
            .astype(np.float32))
    f0, d0 = flash_attention_bh.launches, flash_decode_paged.launches
    want = cpu.forward(batch)[0]
    got = card.forward({k: v.to(cuda) for k, v in batch.items()})[0]
    assert _rel_err(got.cpu(), want) < 1e-4
    caches = [m.cache_init(2, 10) for m in (cpu, card)]
    if cfg.family == "encdec":
        caches[0]["xlayers"] = cpu.encode_cross(batch["audio_embeds"])
        caches[1]["xlayers"] = card.encode_cross(
            batch["audio_embeds"].to(cuda))
    for t in range(10):
        a, _ = cpu.decode_step(caches[0], toks[:, t:t + 1], t)
        b, _ = card.decode_step(caches[1], toks[:, t:t + 1].to(cuda), t)
        assert _rel_err(b.cpu(), a) < 1e-4, t
    gqa = not cfg.mla
    assert (flash_attention_bh.launches > f0) == gqa
    assert (flash_decode_paged.launches > d0) == gqa


# ---------------------------------------------------------------------------
# The training path: the flash kernel's log-sum-exp, the autograd Function
# and a train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 100),
                                           (False, None), (False, 64)])
@pytest.mark.parametrize("H,KV,S", [(4, 4, 300), (8, 2, 1024)])
def test_flash_lse_matches_plain(cuda, dtype, hd, causal, window, H, KV, S):
    """The kernel's lse within 1e-4 of the plain lse (its scale at least
    1), f32 and bf16 (both score in f32 from the same inputs), and the
    output bit-equal with and without it."""
    from repro_torch.kernels.flash_attention import attention
    g = torch.Generator(device=cuda).manual_seed(hd + S)
    q = torch.randn((2, H, S, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((2, KV, S, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((2, KV, S, hd), generator=g, device=cuda).to(dtype)
    n0 = flash_attention_bh.launches
    out, lse = attention(q, k, v, causal=causal, window=window, scale=None,
                         return_lse=True)
    bare = attention(q, k, v, causal=causal, window=window, scale=None)
    torch.cuda.synchronize()
    assert flash_attention_bh.launches == n0 + 2
    assert lse.dtype == torch.float32 and lse.shape == (2, H, S)
    assert torch.equal(out, bare)
    want_out, want = flash_attention_ref(q, k, v, causal=causal,
                                         window=window, return_lse=True)
    assert _rel_err(lse, want) < 1e-4
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert _rel_err(out, want_out) < tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, None)])
@pytest.mark.parametrize("KV", [4, 1])
def test_flash_function_grads_on_the_card(cuda, dtype, causal, window, KV):
    """FlashSDPA with the kernel forward against autograd of the plain
    forward on the same CUDA tensors: the output, dq, dk and dv (f32 within
    1e-4 of scale, bf16 within 2e-2), every one a real gradient.  This is
    the check that the kernel's output reaches autograd: the bare kernel
    would leave q, k and v with none."""
    from repro_torch.models.attention import FlashSDPA
    S, hd = 1100, 128
    g = torch.Generator(device=cuda).manual_seed(7)
    ts = [torch.randn((1, 4 if i == 0 else KV, S, hd), generator=g,
                      device=cuda).to(dtype).requires_grad_()
          for i in range(3)]
    dout = torch.randn((1, 4, S, hd), generator=g, device=cuda).to(dtype)
    n0 = flash_attention_bh.launches
    out = FlashSDPA.apply(*ts, causal, window, hd ** -0.5, True)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, ts, dout)
    torch.cuda.synchronize()
    assert flash_attention_bh.launches == n0 + 1
    plain = flash_attention_ref(*ts, causal=causal, window=window,
                                scale=hd ** -0.5)
    want = torch.autograd.grad(plain, ts, dout)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert _rel_err(out.detach(), plain.detach()) < tol
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == dtype and float(b.abs().max()) > 0
        assert _rel_err(a, b) < tol, name


@pytest.mark.parametrize("arch", ["olmo-1b", "llama3-8b",
                                  "granite-moe-3b-a800m", "zamba2-1.2b",
                                  "whisper-small"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """A reduced registry model (f32, TF32 off), the same weights and batch
    on the card and on the CPU: the loss and every gradient within 1e-4 of
    scale, the card's forward and its remat recompute through the flash
    kernel, and one ``make_train_step``
    step on each."""
    import copy
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import Model
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.steps import loss_and_grads, make_train_step
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(cuda)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)))
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "encdec":
        batch["audio_embeds"] = torch.from_numpy(
            (rng.standard_normal((2, cfg.enc_seq, cfg.d_model)) * 0.02)
            .astype(np.float32))
    cbatch = {k: v.to(cuda) for k, v in batch.items()}
    for m in (cpu, card):
        m.requires_grad_(True)
    l_cpu, g_cpu = loss_and_grads(cpu, batch)
    n0 = flash_attention_bh.launches
    l_card, g_card = loss_and_grads(card, cbatch)
    torch.cuda.synchronize()
    # checkpointed blocks run their attention twice (forward, recompute);
    # Zamba2's shared attention block sits outside the checkpoint
    every = cfg.hybrid_attn_every or cfg.n_layers
    launches = {"dense": 2 * cfg.n_layers, "moe": 2 * cfg.n_layers,
                "hybrid": -(-cfg.n_layers // every),
                "encdec": 2 * (cfg.n_layers + cfg.n_enc_layers)}
    assert flash_attention_bh.launches - n0 == launches[cfg.family]
    assert abs(float(l_card) - float(l_cpu)) < 1e-4 * max(1.0, float(l_cpu))
    for n, g in g_cpu.items():
        assert _rel_err(g_card[n].cpu(), g) < 1e-4, n
    steps = [make_train_step(m, peak_lr=1e-3, warmup=0, total=4)
             for m in (cpu, card)]
    opt_cpu = adamw_init(dict(cpu.named_parameters()))
    opt_card = adamw_init(dict(card.named_parameters()))
    _, m_cpu = steps[0](cpu, opt_cpu, batch)
    _, m_card = steps[1](card, opt_card, cbatch)
    assert abs(float(m_card["loss"]) - float(m_cpu["loss"])) < 1e-4
    assert float(m_card["lr"]) == float(m_cpu["lr"])
    for (n, a), (_, b) in zip(cpu.named_parameters(),
                              card.named_parameters()):
        # one AdamW step moves a weight by at most about lr either way
        assert float((a - b.cpu()).abs().max()) <= 2e-3 * (
            1 + 0.1 * float(a.abs().max())) + 1e-6, n


@pytest.mark.parametrize("arch,mode", [
    ("llama3-8b", "train"), ("llama3-8b", "prefill"), ("llama3-8b", "decode"),
    ("zamba2-1.2b", "prefill"), ("zamba2-1.2b", "decode")])
def test_dry_run_counts_equal_the_live_step(cuda, arch, mode):
    """The dry run's op counter on a reduced bf16 step: the step on fake
    CUDA tensors and the same step run on the card count the same FLOPs,
    bytes and kernel units, and the card's run launched the kernels that
    many times (Zamba2's time loop folded; its train step is not counted,
    ROADMAP A 7.4)."""
    import dataclasses
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.runtime.shard_plan import Strategy
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    mesh, shape = make_local_mesh(), (64, 2, mode)
    with FakeTensorMode():
        fake, _, _, _ = dryrun.count_step(cfg, Model(cfg, device=cuda),
                                          shape, mesh, Strategy())
    model = Model(cfg, device=cuda).init(
        torch.Generator(device=cuda).manual_seed(0))
    wrappers = {"flash_attention_bh": flash_attention_bh,
                "flash_decode_paged": flash_decode_paged}
    before = {k: f.launches for k, f in wrappers.items()}
    live, _, _, _ = dryrun.count_step(cfg, model, shape, mesh, Strategy())
    torch.cuda.synchronize()
    assert (live.flops, live.bytes, live.units) == (fake.flops, fake.bytes,
                                                    fake.units)
    assert live.units and all(n > 0 for n in live.units.values())
    assert {k: f.launches - before[k] for k, f in wrappers.items()} == {
        k: live.units.get(k, 0) for k in wrappers}
