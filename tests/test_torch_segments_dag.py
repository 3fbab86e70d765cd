"""The port's segment programs on the DAG models (``inception``,
``resnet101``, ``resnet18``) against the eager records and the JAX
``Session``; the chain models and the cache itself are in
``test_torch_segments.py`` (the two files run on separate workers)."""
import pytest

from torch_conformance import check_segment_programs


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("name", ["inception", "resnet101", "resnet18"])
def test_segment_programs_equal_the_eager_records_on_dags(name, backend):
    check_segment_programs(name, backend)
