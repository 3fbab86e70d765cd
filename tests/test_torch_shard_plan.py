"""The port's LM planner against the JAX reference's, on shapes alone: the
sharding rules (``runtime/shard_plan.py``) leaf for leaf at full width,
the planner's proxy graph, its roofline estimator under the v5e constants
and the chosen ``Strategy`` (``runtime/planner.py``).

The reference side takes its shapes from ``jax.eval_shape`` (nothing is
allocated or compiled), the port's from a ``Model`` on the ``meta``
device.  The port's parameters are per layer: its spec of
``blocks.3.attn.wq`` is the reference's spec of the stacked
``blocks/attn/wq`` with the leading (layer) ``None`` dropped."""
import functools

import jax
import pytest
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs.registry import ARCH_IDS as J_ARCH_IDS
from repro.configs.registry import get_config as j_get_config
from repro.data import make_batch_specs as j_make_batch_specs
from repro.models.transformer import Model as JModel
from repro.runtime import planner as jplanner
from repro.runtime import shard_plan as jsp
from repro.core.dpp import Objective as JObjective

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.dpp import Objective
from repro_torch.data import make_batch_specs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (HBM_BW, LINK_BW, PEAK_FLOPS_BF16,
                                     make_local_mesh, make_production_mesh)
from repro_torch.models.transformer import STACKED, Model
from repro_torch.runtime import planner, shard_plan as sp
from repro_torch.runtime.shard_plan import P, Strategy


class FakeMesh:
    """Axis sizes only: what both packages' rules read of a mesh."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"16x16": FakeMesh({"data": 16, "model": 16}),
          "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16})}
STRATEGIES = [(Strategy(attn="tp", ffn="tp", moe="ep"),
               jsp.Strategy(attn="tp", ffn="tp", moe="ep")),
              (Strategy(attn="sp", ffn="sp", moe="tp"),
               jsp.Strategy(attn="sp", ffn="sp", moe="tp")),
              (Strategy(attn="tp", ffn="tp", fsdp=False,
                        decode_resident=True),
               jsp.Strategy(attn="tp", ffn="tp", fsdp=False,
                            decode_resident=True))]
MODES = ("train", "prefill", "decode")
V5E = dict(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)


def _jpath(kp) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in kp)


@functools.lru_cache(maxsize=None)
def ref_shapes(arch):
    """The reference's parameter pytree as shapes."""
    return jax.eval_shape(
        lambda: JModel(j_get_config(arch)).init(jax.random.PRNGKey(0)))


def ref_params(arch):
    return {_jpath(kp): leaf for kp, leaf in
            jax.tree_util.tree_flatten_with_path(ref_shapes(arch))[0]}


@functools.lru_cache(maxsize=None)
def port_model(arch):
    return Model(get_config(arch), device="meta")


def ref_name(name: str) -> str:
    """The reference's key path of the port's parameter ``name``."""
    parts = name.split(".")
    if parts[0] in STACKED:
        parts = [parts[0]] + parts[2:]
    return "/".join(parts)


def ref_flat_specs(specs):
    flat_s = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))[0]
    return {_jpath(kp): tuple(s) for kp, s in flat_s}


def port_flat(tree):
    out = {}
    sp.tree_map(lambda path, leaf: out.__setitem__(path.replace(".", "/"),
                                                   leaf), tree)
    return out


def test_archs_and_mesh_shapes():
    assert tuple(ARCH_IDS) == tuple(J_ARCH_IDS)
    m1, m2 = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert m1.axis_names == ("data", "model") and m1.size == 256
    assert m2.axis_names == ("pod", "data", "model") and m2.size == 512
    assert m1.shape == {"data": 16, "model": 16}
    assert make_local_mesh().shape == {"data": 1, "model": 1}
    assert (PEAK_FLOPS_BF16, HBM_BW, LINK_BW) == (989e12, 3.35e12, 50e9)


@pytest.mark.parametrize("si", range(len(STRATEGIES)))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch, si):
    st, jst = STRATEGIES[si]
    model, ref = port_model(arch), ref_params(arch)
    names = dict(model.named_parameters())
    assert sorted({ref_name(n) for n in names}) == sorted(ref)
    for mname, mesh in MESHES.items():
        for mode in MODES:
            ours = sp.param_specs(model, mesh, st, mode)
            theirs = ref_flat_specs(jsp.param_specs(ref_shapes(arch), mesh,
                                                    jst, mode))
            for name, spec in ours.items():
                want = theirs[ref_name(name)]
                if name.split(".")[0] in STACKED:
                    assert want[0] is None, (name, want)
                    want = want[1:]
                assert isinstance(spec, P)
                assert tuple(spec) == want, (arch, mname, mode, name)
                # every emitted spec divides its tensor
                assert sp._fits(tuple(names[name].shape), spec, mesh)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_equal_reference(arch):
    cfg = get_config(arch)
    jcache = jax.eval_shape(
        lambda: JModel(j_get_config(arch)).cache_init(128, 4096))
    cache = port_model(arch).cache_init(128, 4096)
    for mname, mesh in MESHES.items():
        theirs = ref_flat_specs(jsp.cache_specs(jcache, mesh,
                                                jsp.Strategy()))
        ours = port_flat(sp.cache_specs(cache, mesh, Strategy()))
        leaves = port_flat(cache)
        extra = sorted(set(ours) - set(theirs))
        # the port's GQA caches carry the decode kernel's page table
        assert all(p.endswith("/table") for p in extra), extra
        assert set(theirs) <= set(ours)
        for path, want in theirs.items():
            assert tuple(ours[path]) == want, (arch, mname, path)
        for path in extra:
            assert tuple(ours[path]) == (None,)
            assert sp._fits(tuple(leaves[path].shape), ours[path], mesh)
        for mode, (s, b) in (("train", (4096, 256)), ("prefill", (32768, 32)),
                             ("decode", (32768, 128))):
            jb = jsp.batch_specs(j_make_batch_specs(
                j_get_config(arch), s, b, mode=mode), mesh)
            pb = sp.batch_specs(make_batch_specs(cfg, s, b, mode=mode), mesh)
            assert {k: tuple(v) for k, v in pb.items()} == \
                {k: tuple(v) for k, v in jb.items()}


def test_opt_specs_inherit_param_specs():
    mesh = MESHES["16x16"]
    p_spec = sp.param_specs(port_model("olmo-1b"), mesh, Strategy(), "train")
    o_spec = sp.opt_specs(p_spec)
    j_o = jsp.opt_specs("p", None)
    assert set(o_spec) == set(j_o) == {"m", "v", "step"}
    assert o_spec["m"] is p_spec and o_spec["v"] is p_spec
    assert tuple(o_spec["step"]) == tuple(j_o["step"]) == ()


def test_local_shape_is_xla_shard_shape():
    for mname, mesh in MESHES.items():
        amesh = AbstractMesh(tuple(mesh.shape.values()), mesh.axis_names)
        model = port_model("llama3-8b")
        for name, spec in sp.param_specs(model, mesh, Strategy(),
                                         "train").items():
            shape = tuple(dict(model.named_parameters())[name].shape)
            want = NamedSharding(amesh, JP(*spec)).shard_shape(shape)
            assert sp.local_shape(shape, spec, mesh) == tuple(want)
            assert sp.named({"x": spec}, mesh)["x"].shard_shape(shape) \
                == tuple(want)


def _ref_local_bytes(specs, shapes, mesh):
    amesh = AbstractMesh(tuple(mesh.shape.values()), mesh.axis_names)
    flat_s = jax.tree_util.tree_leaves(specs,
                                       is_leaf=lambda x: isinstance(x, JP))
    flat_t = jax.tree_util.tree_leaves(shapes)
    assert len(flat_s) == len(flat_t)
    total = 0
    for spec, leaf in zip(flat_s, flat_t):
        shard = NamedSharding(amesh, spec).shard_shape(tuple(leaf.shape))
        n = 1
        for d in shard:
            n *= d
        total += n * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_argument_bytes_equal_reference_shards(shape):
    """olmo-1b's per-card argument bytes on 16 x 16: the port's dry run
    against the sum of the shards of the reference's own leaves under
    its own specs and strategy."""
    from repro.optim import adamw_init as j_adamw_init
    from torch_lm_cases import ref_dryrun_shapes
    from torch._subclasses.fake_tensor import FakeTensorMode
    seq, batch, mode = ref_dryrun_shapes()[shape]
    assert dryrun.SHAPES[shape] == (seq, batch, mode)
    mesh = MESHES["16x16"]
    jcfg, cfg = j_get_config("olmo-1b"), get_config("olmo-1b")
    jst = jplanner.choose_strategy(jcfg, mesh, mode)
    st = Strategy(**vars(jst))
    jp = ref_shapes("olmo-1b")
    p_spec = jsp.param_specs(jp, mesh, jst, mode)
    want = _ref_local_bytes(p_spec, jp, mesh)
    extra = 0
    if mode == "train":
        jo = jax.eval_shape(lambda: j_adamw_init(jp))
        want += _ref_local_bytes(jsp.opt_specs(p_spec, jp), jo, mesh)
        jb = j_make_batch_specs(jcfg, seq, batch, mode="train")
        want += _ref_local_bytes(jsp.batch_specs(jb, mesh), jb, mesh)
    else:
        jc = jax.eval_shape(
            lambda: JModel(jcfg).cache_init(batch, seq))
        want += _ref_local_bytes(jsp.cache_specs(jc, mesh, jst), jc, mesh)
        want += batch // 16 * 4            # the [B, 1] int32 tokens
        # the port's one page table (every layer's), replicated
        extra = 4 * (seq // 16)
    with FakeTensorMode():
        model = Model(cfg, device=dryrun.fake_device())
        inputs = dryrun.build_inputs(cfg, model, shape, mesh, st)
        got = dryrun.argument_bytes(inputs, mesh)
    assert got == want + extra


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_proxy_graph_and_estimator_equal_reference(arch):
    from repro.core.cost import Testbed as JTestbed
    from repro.core.partition import Scheme as JScheme
    from repro_torch.core.cost import Testbed
    from repro_torch.core.partition import Scheme
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for m in (16, 4):
        for tokens in (4096, 32768, 1):
            g, div, kv = planner._proxy_graph(cfg, tokens, m)
            jg, jdiv, jkv = jplanner._proxy_graph(jcfg, tokens, m)
            assert g.name == jg.name and len(g.layers) == len(jg.layers)
            for a, b in zip(g.layers, jg.layers):
                assert vars(a).keys() == vars(b).keys()
                for f in vars(a):
                    assert getattr(a, f) == getattr(b, f) or (
                        str(getattr(a, f)) == str(getattr(b, f))), f
            assert div == jdiv and kv == jkv
            est = planner.H100RooflineEstimator(m, div, kv, **V5E)
            jest = jplanner.TpuRooflineEstimator(m, jdiv, jkv)
            tb, jtb = Testbed(nodes=m), JTestbed(nodes=m)
            for a, b in zip(g.layers, jg.layers):
                nxt = g.layers[1] if a is g.layers[0] and len(
                    g.layers) > 1 else None
                jnxt = jg.layers[1] if nxt is not None else None
                for s, js in zip((Scheme.INH, Scheme.OUTC),
                                 (JScheme.INH, JScheme.OUTC)):
                    assert est.i_cost(a, s, tb) == jest.i_cost(b, js, jtb)
                    for d, jd in zip((Scheme.INH, Scheme.OUTC),
                                     (JScheme.INH, JScheme.OUTC)):
                        assert est.s_cost(a, nxt, s, d, tb) == \
                            jest.s_cost(b, jnxt, js, jd, jtb)
                        assert est.s_cost(a, None, s, d, tb) == \
                            jest.s_cost(b, None, js, jd, jtb)


OBJECTIVES = [(Objective.LATENCY, JObjective.LATENCY, None),
              (Objective.THROUGHPUT, JObjective.THROUGHPUT, None),
              (Objective.P99_BOUNDED, JObjective.P99_BOUNDED, 1e-3)]


@pytest.mark.parametrize("oi", range(len(OBJECTIVES)))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_choose_strategy_equals_reference(arch, oi):
    obj, jobj, bound = OBJECTIVES[oi]
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for m in (16, 4):
        mesh = FakeMesh({"data": 16, "model": m})
        for mode in MODES:
            def run(fn, c, o, **kw):
                try:
                    return vars(fn(c, mesh, mode, objective=o,
                                   latency_bound_s=bound, **kw))
                except Exception as e:          # both must fail alike
                    return type(e).__name__
            ours = run(planner.choose_strategy, cfg, obj, **V5E)
            theirs = run(jplanner.choose_strategy, jcfg, jobj)
            assert ours == theirs, (arch, m, mode, obj)
            h100 = run(planner.choose_strategy, cfg, obj)
            if isinstance(h100, dict):
                assert h100["attn"] in ("tp", "sp")
                assert h100["ffn"] in ("tp", "sp")
                if cfg.moe and cfg.moe.n_experts % m:
                    assert h100["moe"] == "tp"


def test_frontier_path_matches_its_oracle():
    """The port of the reference's objective test on the planner's proxy:
    THROUGHPUT through the scalar-provider frontier path equals the
    exhaustive oracle, on the H100's constants and on v5e's."""
    from repro_torch.core.cost import Testbed
    from repro_torch.core.dpp import plan_search
    from repro_torch.core.exhaustive import exhaustive_search
    from repro_torch.core.partition import Scheme
    cfg = get_config("olmo-1b")
    graph, div, kv = planner._proxy_graph(cfg, 4096, 4)
    schemes = (Scheme.INH, Scheme.OUTC)
    for consts in ({}, V5E):
        est = planner.H100RooflineEstimator(4, div, kv, **consts)
        tb = Testbed(nodes=4, bandwidth_gbps=LINK_BW * 8 / 1e9)
        res = plan_search(graph, est, tb, schemes=schemes,
                          objective=Objective.THROUGHPUT)
        _, ex = exhaustive_search(graph, est, tb, schemes=schemes,
                                  objective=Objective.THROUGHPUT)
        assert abs(res.cost - ex) / ex < 1e-9
