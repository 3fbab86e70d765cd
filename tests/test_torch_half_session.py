"""MobileNet v1 and ResNet-18 (width 32; ResNet-18 for its ADD merges) in
bf16 on the port's ``Session`` against the reference's, on the CPU: the
carried bf16 weights bit-equal, the port's ``backend="cuda"`` local and
on the mesh against the reference's ``"pallas"``, its ``"torch"`` against
``"xla"``, within 2e-2 of scale with ``ExecStats`` equal (see
``torch_half_cases``).  bert-base is in ``test_torch_half.py``."""
import pytest
import torch

from torch_half_cases import SESSION_CASES, check_bf16_session


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", [c for c in SESSION_CASES
                                  if c[0] != "bert"],
                         ids=lambda c: "-".join(map(str, c)))
def test_cnn_bf16_session(case):
    check_bf16_session(*case)
