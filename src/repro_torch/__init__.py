"""FlexPie on PyTorch and CUDA: the port of the JAX package ``repro`` to
one NVIDIA H100.

It imports ``torch`` and numpy, never JAX and never the ``repro``
package.  The curated surface — plan, then run:

    import torch
    from repro_torch import (AnalyticEstimator, ExecConfig, Session,
                             Testbed, init_weights, plan_search)
    from repro_torch.configs.edge_models import mobilenet_v1

    graph = mobilenet_v1()
    weights = init_weights(graph, torch.Generator().manual_seed(0))
    res = plan_search(graph, AnalyticEstimator(), Testbed(nodes=4))
    out, stats = Session(graph, weights, res.plan, 4,
                         ExecConfig(backend="cuda")).run(x)

Entry points run on the card (``device="cuda"``) unless the caller asks
for ``device="cpu"``.  Deeper layers stay importable from the subpackages
``repro_torch.core``, ``repro_torch.kernels``, ``repro_torch.runtime``
and ``repro_torch.configs``.
"""
from repro_torch.core import (AnalyticEstimator, Mode, Plan, Scheme,
                              Testbed, fixed_plan, plan_search)
from repro_torch.runtime import (ExecConfig, ExecStats, Session,
                                 init_weights, run_reference,
                                 weights_from_numpy)

__all__ = [
    "plan_search", "AnalyticEstimator", "Testbed", "Session", "ExecConfig",
    "ExecStats", "init_weights", "weights_from_numpy", "run_reference",
    "fixed_plan", "Plan", "Scheme", "Mode",
]
