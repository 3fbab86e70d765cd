"""The two shard kernels' wrappers in every operand pair the card takes,
at stride 2, 1x1, dense and depthwise, and the FC shard; then bert-base
(full width, 2 layers) in bf16 on the port's ``Session`` against the
reference's.  The rule and the helpers are in ``torch_half_cases.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import matmul_tiled as j_matmul_tiled

from repro_torch.kernels.ops import matmul_tiled

from torch_half_cases import (PAIR_IDS, PAIRS, SESSION_CASES,
                              check_bf16_session, check_conv, operands,
                              to_torch)
from torch_ulps import holds_one_ulp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: (k, stride, shard pads, depthwise)
GEOMS = ((3, 2, (1, 0, 1, 0), False),
         (3, 2, (0, 1, 0, 1), True),
         (1, 1, (0, 0, 0, 0), False),
         (3, 1, (1, 1, 1, 1), True),
         (3, 1, (0, 1, 1, 0), False))


@pytest.mark.parametrize("k,s,pads,dw", GEOMS,
                         ids=[f"k{g[0]}s{g[1]}-{'dw' if g[3] else 'dense'}"
                              f"-{g[2]}" for g in GEOMS])
@pytest.mark.parametrize("xd,wd", PAIRS, ids=PAIR_IDS)
def test_conv_shard_pairs(xd, wd, k, s, pads, dw):
    """Stride 2 and 1x1 shards, dense and depthwise, in every pair."""
    check_conv(xd, wd, k, s, pads, dw, seed=k + 7 * s)


FC_SHAPES = ((16, 32, 96), (1, 32, 10), (37, 16, 100), (128, 64, 3),
             (32, 96, 72))


@pytest.mark.parametrize("m,cin,cout", FC_SHAPES,
                         ids=["x".join(map(str, c)) for c in FC_SHAPES])
@pytest.mark.parametrize("xd,wd", PAIRS, ids=PAIR_IDS)
def test_fc_shard_pairs(xd, wd, m, cin, cout):
    """The FC shard, the weight whole and as the plan's column slice."""
    rng = np.random.default_rng(m + cin)
    xj, xt = operands(rng, (m, cin), xd)
    wj, wt = operands(rng, (cin, cout + 6), wd, 0.1)
    for a, b in ((0, cout), (3, 3 + cout)):
        ref = j_matmul_tiled(xj, wj[:, a:b], tile_m=8)
        want = to_torch(ref)
        out = matmul_tiled(xt, wt[:, a:b])
        assert out.dtype == want.dtype
        holds_one_ulp(out, want, xt.float().abs() @ wt[:, a:b].float().abs())


@pytest.mark.parametrize("case", [c for c in SESSION_CASES
                                  if c[0] == "bert"],
                         ids=lambda c: "-".join(map(str, c)))
def test_bert_bf16_session(case):
    check_bf16_session(*case)
