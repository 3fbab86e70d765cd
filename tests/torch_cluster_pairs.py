"""Shared pieces of the planner-stack conformance tests
(``tests/test_torch_{cluster,frontier,frontier_dag,refine}.py``): the same
cluster, graph and plan built in both packages, and field-by-field
comparisons of their results.  The reference side of these modules is
numpy only, so nothing here compiles a kernel."""
import dataclasses
import enum
import math

import numpy as np

import repro.cluster as jcl
from repro.core.dpp import Objective as JObjective
from repro.configs.edge_models import EDGE_MODELS as J_MODELS
from repro.core import graph as jgraph
from repro.core.partition import Mode as JMode
from repro.core.partition import Scheme as JScheme
from repro.core.plan import Plan as JPlan

import repro_torch.cluster as tcl
from repro_torch.configs.edge_models import EDGE_MODELS as T_MODELS
from repro_torch.core import graph as tgraph
from repro_torch.core.dpp import Objective
from repro_torch.core.partition import Mode, Scheme
from repro_torch.core.plan import Plan
from torch_conformance import MODEL_TEST_KW

#: the frontier grid's clusters: (preset name, nodes)
CLUSTERS = (("uniform", 2), ("uniform", 4), ("mixed_fast_slow", 6),
            ("stepped", 4), ("asym_uplink", 4))


def cluster_id(c) -> str:
    return f"{c[0]}{c[1]}"


def clusters(preset: str, nodes: int, **kw):
    """(reference cluster, port cluster) of one preset."""
    return (jcl.CLUSTER_PRESETS[preset](nodes, **kw),
            tcl.CLUSTER_PRESETS[preset](nodes, **kw))


def graphs(name: str, scale: str = "full"):
    """(reference graph, port graph) of one edge model."""
    kw = {} if scale == "full" else MODEL_TEST_KW[name]
    return J_MODELS[name](**kw), T_MODELS[name](**kw)


def _toy_chain(g, h=20):
    L, C = g.LayerSpec, g.ConvT
    return g.chain("toy", [
        L("c0", C.CONV, h, h, 3, 8, 3, 1, 1),
        L("dw", C.DWCONV, h, h, 8, 8, 3, 1, 1),
        L("pw", C.POINTWISE, h, h, 8, 16, 1, 1, 0),
        L("c1", C.CONV, h, h, 16, 16, 3, 2, 1),
        L("c2", C.CONV, h // 2, h // 2, 16, 8, 3, 1, 1),
    ])


def _toy_dag(g, h=16):
    L, C = g.LayerSpec, g.ConvT
    return g.ModelGraph(name="rb", layers=(
        L("c0", C.CONV, h, h, 3, 8, 3, 1, 1),
        L("ba", C.CONV, h, h, 8, 8, 3, 1, 1, inputs=("c0",)),
        L("bb", C.CONV, h, h, 8, 8, 3, 1, 1, inputs=("ba",)),
        L("add", C.ADD, h, h, 8, 8, inputs=("bb", "c0")),
        L("c1", C.CONV, h, h, 8, 8, 3, 1, 1),
    ))


def toy_chain():
    """The reference tests' 5-layer toy chain (tests/test_cluster.py)."""
    return _toy_chain(jgraph), _toy_chain(tgraph)


def toy_dag():
    """The reference tests' residual-block toy DAG."""
    return _toy_dag(jgraph), _toy_dag(tgraph)


def steps(plan):
    return [(int(s), int(m)) for s, m in plan.steps]


def to_jplan(plan) -> JPlan:
    return JPlan(tuple((JScheme(int(s)), JMode(int(m)))
                       for s, m in plan.steps))


def plain(x):
    """A comparable form of a result: enums by value, dataclasses and
    tuples field by field (a frontier by its points, stats and every
    point's plan), numpy arrays as lists, NaN as a marker."""
    if isinstance(x, (Scheme, Mode, JScheme, JMode)):
        return int(x)
    if isinstance(x, enum.Enum):
        return plain(x.value)
    if isinstance(x, (Plan, JPlan)):
        return steps(x)
    if isinstance(x, (tcl.PlanFrontier, jcl.PlanFrontier)):
        return {"schemes": plain(x.schemes), "points": plain(x.points),
                "stats": plain(x.stats),
                "plans": [steps(x.plan(i)) for i in range(len(x))]}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, np.ndarray):
        return plain(x.tolist())
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    if isinstance(x, np.generic):
        return plain(x.item())
    return x


class Occ:
    """A scalar-occupancy sample (the shape of
    ``ExecStats.to_occupancy()``) fed identically to both packages."""

    def __init__(self, dev, link, period=None, failures=0):
        self.dev_occupancy_s = dev
        self.link_occupancy_s = link
        self.period_s = max(dev, link) if period is None else period
        self.failures = failures


#: (compute_scale, sync_scale) re-weightings, the refinement loop's
#: extremes included
SCALES = ((1.0, 1.0), (1e6, 1.0), (1.0, 1e6), (0.3, 2.0), (2.5, 0.01),
          (1e-3, 1e-3))


def check_frontier(name, cluster, prune_ub):
    gj, gt = graphs(name)
    jc, tc = clusters(*cluster)
    fj = jcl.cluster_pipeline_frontier(gj, jc, prune_ub=prune_ub)
    ft = tcl.cluster_pipeline_frontier(gt, tc, prune_ub=prune_ub)
    assert ft.points.dtype == fj.points.dtype
    assert np.array_equal(ft.points, fj.points)
    assert plain(ft.stats) == plain(fj.stats)
    assert [int(s) for s in ft.schemes] == [int(s) for s in fj.schemes]
    for i in range(len(ft)):
        assert steps(ft.plan(i)) == steps(fj.plan(i)), i
    lat = float(np.min(ft.points.sum(axis=1)))
    for cs, ss in SCALES:
        for obj, bound in ((Objective.THROUGHPUT, None),
                           (Objective.LATENCY, None),
                           (Objective.P99_BOUNDED, lat * 1.05),
                           (Objective.P99_BOUNDED, lat * 0.5)):
            got = ft.select(obj, bound, compute_scale=cs, sync_scale=ss)
            want = fj.select(JObjective(obj.value), bound,
                             compute_scale=cs, sync_scale=ss)
            assert got == want, (obj, bound, cs, ss)


def check_searches(name, cluster):
    """THROUGHPUT and P99_BOUNDED ``plan_search``: the same plan, cost and
    ``PipelineCost`` as the reference's; LATENCY keeps its plan."""
    gj, gt = graphs(name)
    jc, tc = clusters(*cluster)
    lat_t = tcl.cluster_plan_search(gt, tc)
    lat_j = jcl.cluster_plan_search(gj, jc)
    assert steps(lat_t.plan) == steps(lat_j.plan)
    assert lat_t.cost == lat_j.cost
    assert lat_t.objective == Objective.LATENCY and lat_t.pipeline is None
    for obj, bound in ((Objective.THROUGHPUT, None),
                       (Objective.P99_BOUNDED, lat_t.cost * 1.1),
                       (Objective.P99_BOUNDED, lat_t.cost * 0.5)):
        got = tcl.cluster_plan_search(gt, tc, objective=obj,
                                      latency_bound_s=bound)
        want = jcl.cluster_plan_search(gj, jc, objective=JObjective(
            obj.value), latency_bound_s=bound)
        assert steps(got.plan) == steps(want.plan), (obj, bound)
        assert got.cost == want.cost
        assert plain(got.pipeline) == plain(want.pipeline)
        assert plain(got.stats) == plain(want.stats)
        assert got.objective == obj
