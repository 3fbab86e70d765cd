"""The CUDA kernels, the ``backend="cuda"`` engine and the
``backend="cuda"`` decode session on the card.

Every test here needs a CUDA device: it carries the ``gpu`` marker and
skips (inside the ``cuda`` fixture, never at import) where there is none.
The file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors; the tolerance is the reference's scale-normalised 1e-4, because
the kernel and the plain version sum in f32 in different orders (TF32 is
switched off for the plain versions).
"""
import numpy as np
import pytest
import torch

from repro_torch import (AnalyticEstimator, DecodeSession, ExecConfig,
                         Session, TransformerSpec, greedy_decode,
                         init_transformer, init_weights, plan_decode,
                         plan_search, reference_decode, run_reference)
from repro_torch import Testbed as TorchTestbed
from repro_torch.configs.edge_models import EDGE_MODELS
from repro_torch.core.graph import ConvT, conv_geometries, shard_halo_pads
from repro_torch.kernels import ops
from repro_torch.kernels.conv2d import conv2d_shard
from repro_torch.kernels.flash_attention import (flash_attention_bh,
                                                 flash_decode_paged)
from repro_torch.kernels.ops import matmul_tiled
from repro_torch.kernels.ref import (conv2d_shard_ref, flash_attention_ref,
                                     flash_decode_paged_ref, live_pages,
                                     matmul_ref)

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


FLASH_CASES = [
    # B, H, KV, S, hd, causal, window, dtype, tol
    (1, 16, 16, 512, 128, True, None, torch.float32, 1e-4),
    (1, 8, 2, 300, 128, True, 100, torch.float32, 1e-4),
    (2, 4, 4, 257, 64, False, None, torch.float32, 1e-4),
    (1, 4, 4, 200, 32, False, 50, torch.float32, 1e-4),
    (1, 2, 1, 700, 256, True, None, torch.float32, 1e-4),
    (1, 8, 2, 384, 128, True, None, torch.bfloat16, 2e-2),
    (1, 4, 4, 100, 64, False, None, torch.bfloat16, 2e-2),
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
