"""The port's engine against the JAX package's on the branched models
(ResNet-18/101 residual DAGs, the Inception-style CONCAT modules): the
same checks as ``test_torch_engine.py``, on separate workers."""
import pytest

from torch_conformance import PLANS, check_run_reference, check_session

DAGS = ["inception", "resnet101", "resnet18"]


@pytest.mark.parametrize("kind", PLANS)
@pytest.mark.parametrize("name", DAGS)
def test_session_matches_reference(name, kind):
    check_session(name, kind)


@pytest.mark.parametrize("name", DAGS)
def test_run_reference_matches(name):
    check_run_reference(name)
