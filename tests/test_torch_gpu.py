"""The CUDA kernels and the ``backend="cuda"`` engine on the card.

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

from repro_torch import (AnalyticEstimator, ExecConfig, Session,
                         init_weights, plan_search, run_reference)
from repro_torch import Testbed as TorchTestbed
from repro_torch.configs.edge_models import EDGE_MODELS
from repro_torch.core.graph import ConvT, conv_geometries, shard_halo_pads
from repro_torch.kernels.conv2d import conv2d_shard
from repro_torch.kernels.ops import matmul_tiled
from repro_torch.kernels.ref import conv2d_shard_ref, matmul_ref

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
