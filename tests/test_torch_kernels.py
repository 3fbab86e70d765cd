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
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import matmul_tiled as j_matmul_tiled
from repro.kernels.ref import conv2d_shard_ref as j_conv2d_shard_ref

from repro_torch.kernels import build, ops
from repro_torch.kernels.conv2d import (UnsupportedGeometry, conv2d_shard,
                                        shard_out_shape)
from repro_torch.kernels.ops import matmul_tiled
from repro_torch.kernels.ref import conv2d_shard_ref, matmul_ref

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


def test_kernel_build_is_lazy_and_keyed_by_source():
    """Importing the kernels builds nothing; the library path is a pure
    function of the source and flags, one per source."""
    assert build._LOADED == {}
    assert set(build.SIGNATURES) == {p.stem for p in build.CSRC.glob("*.cu")}
    for name in build.SIGNATURES:
        p = build.lib_path(name)
        assert p == build.lib_path(name)
        assert p.parent == build.BUILD_DIR and p.name.startswith(name)
    assert build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


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
