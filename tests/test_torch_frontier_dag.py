"""The port's throughput planner on the residual DAGs (ResNet-18 and
ResNet-101 at full size) against the JAX package's: the frontier grid of
``test_torch_frontier.py``, split off to keep each file near a minute."""
import pytest

from torch_cluster_pairs import (CLUSTERS, check_frontier, check_searches,
                                 cluster_id)

MODELS = ("resnet18", "resnet101")


@pytest.mark.parametrize("prune_ub", [True, False], ids=["pruned", "full"])
@pytest.mark.parametrize("cluster", CLUSTERS, ids=cluster_id)
@pytest.mark.parametrize("name", MODELS)
def test_frontier_matches(name, cluster, prune_ub):
    check_frontier(name, cluster, prune_ub)


@pytest.mark.parametrize("cluster", CLUSTERS, ids=cluster_id)
@pytest.mark.parametrize("name", MODELS)
def test_throughput_searches_match(name, cluster):
    check_searches(name, cluster)
