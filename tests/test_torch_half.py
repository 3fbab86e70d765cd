"""The two shard kernels' wrappers in bf16 and fp16 against the Pallas
kernels in interpret mode, on the CPU.

There the wrappers run their plain versions, which read every element as
f32, sum in f32 and round once to ``x.dtype``, as the Pallas kernels do;
so each output is held to the reference's within one ulp of the output
dtype, element by element (``torch_ulps.holds_one_ulp``), and its dtype
to the reference's.  The operand pairs: both in bf16 or fp16, a half
``x`` with f32 weights, and two the card reaches through an exact upcast
of the weight (an f32 ``x`` with bf16 weights, bf16 with fp16).  The
CUDA kernels themselves are held against the plain versions on the card
(``tests/test_torch_gpu.py``).  Here: every shard pad signature of the
3x3 geometry; the other geometries in every pair, the FC shapes and
bert-base's bf16 ``Session`` in ``test_torch_half_pairs.py``; MobileNet
v1 and ResNet-18 in ``test_torch_half_session.py``.
"""
import pytest
import torch

from repro_torch.core.graph import shard_halo_pads

from torch_half_cases import check_conv


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("pads", shard_halo_pads(1), ids=str)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_dense_3x3_shard_every_pad_signature(dtype, pads):
    check_conv(dtype, dtype, 3, 1, pads, False, seed=sum(pads))


@pytest.mark.parametrize("pads", shard_halo_pads(1), ids=str)
def test_depthwise_3x3_shard_every_pad_signature_bf16(pads):
    check_conv("bfloat16", "bfloat16", 3, 1, pads, True, seed=10 + sum(pads))
