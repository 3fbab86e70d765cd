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

Autoregressive decode of a head-sharded plan over the paged KV cache:

    from repro_torch import (DecodeSession, TransformerSpec, greedy_decode,
                             init_transformer, plan_decode)

    spec = TransformerSpec(n_layers=2, d_model=256, n_heads=8, d_ff=1024)
    weights = init_transformer(spec, seed=0)
    plan = plan_decode(spec, kv_len=2048, nodes=4).plan
    tokens, logits = greedy_decode(DecodeSession(spec, weights, plan, 4),
                                   prompt=[3, 17], n_new=8)

The same plan on the mesh executor — each node a CUDA stream of the card,
one captured graph a pipeline stage, halo exchange and gathers as device
copies:

    out, stats = Session(graph, weights, res.plan, 4,
                         ExecConfig(executor="mesh")).run(x)

The paper's data-driven loop — traces, GBDT estimators fit on the card,
DPP on learned costs — and the §4 baselines it is compared against:

    est = train_estimators(TraceConfig())         # 330K traces, 120 trees
    res = plan_search(graph, est, Testbed(nodes=4))
    rows = baselines.all_solutions(graph, est, Testbed(nodes=4))

The LM substrate's serving path — a registry architecture, its seeded
weights (or the JAX package's, carried with ``params_from_numpy``),
prefill and KV-cache decode, attention through the hand-written flash and
paged-decode kernels:

    from repro_torch.launch import serve
    res = serve.main(["--arch", "llama3-8b", "--full"])   # bf16 on the card
    model = Model(get_config("olmo-1b").reduced(), device="cpu")

``baselines`` is a module, importable from here but kept out of
``__all__``: ``from repro_torch import *`` brings no module, as the JAX
package's does not.  Entry points run on the card (``device="cuda"``)
unless the caller asks for ``device="cpu"``.  Deeper layers stay importable from the subpackages
``repro_torch.core``, ``repro_torch.gbdt``, ``repro_torch.sim``,
``repro_torch.models``,
``repro_torch.cluster``, ``repro_torch.kernels``, ``repro_torch.runtime``,
``repro_torch.launch`` and ``repro_torch.configs``.
"""
from repro_torch.core import (AnalyticEstimator, ConvT, GBDTEstimator,
                              LayerSpec, Mode, ModelGraph, Objective, Plan,
                              Scheme, SearchResult, Testbed, Topology,
                              baselines, chain, exhaustive_search,
                              fixed_plan, plan_search)
from repro_torch.cluster import (ClusterSpec, cluster_plan_search,
                                 homogeneous, mixed_fast_slow)
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch import make_nodes_mesh
from repro_torch.models import Model, params_from_numpy
from repro_torch.sim import TraceConfig, train_estimators
from repro_torch.runtime import (EXECUTORS, DecodeSession, ExecConfig,
                                 ExecStats, PagedKVCache, Session,
                                 TransformerSpec,
                                 decode_graph, greedy_decode,
                                 init_transformer, init_weights, plan_decode,
                                 prefill_graph, reference_decode,
                                 run_reference,
                                 transformer_weights_from_numpy,
                                 weights_from_numpy)

__all__ = [
    # the JAX package's surface
    "AnalyticEstimator", "ConvT", "LayerSpec", "Mode", "ModelGraph",
    "Objective", "Plan", "Scheme", "SearchResult", "Testbed", "Topology",
    "chain", "fixed_plan", "plan_search",
    "ClusterSpec", "cluster_plan_search", "homogeneous", "mixed_fast_slow",
    "ExecConfig", "Session", "ExecStats", "init_weights", "run_reference",
    "DecodeSession", "TransformerSpec", "PagedKVCache", "decode_graph",
    "prefill_graph", "init_transformer", "reference_decode",
    "greedy_decode", "plan_decode",
    # the port's own
    "weights_from_numpy", "transformer_weights_from_numpy", "EXECUTORS",
    "make_nodes_mesh", "GBDTEstimator", "exhaustive_search",
    "TraceConfig", "train_estimators", "Model", "params_from_numpy",
    "ARCH_IDS", "get_config",
]
