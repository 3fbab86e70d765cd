"""The port's mesh executor on the branched models (ResNet-18/101 residual
DAGs, the Inception-style CONCAT modules) against the JAX local
``Session``, and the mesh's measured stage structure on all five models
against the reference simulator's (``repro.cluster.build_stages``), as
``tests/test_mesh_exec.py`` holds the reference's mesh to it, and against
the port's own simulator (``repro_torch.cluster.build_stages``), which
must build the reference's stages one for one."""
import pytest
import torch

from repro.cluster import build_stages, homogeneous

import repro_torch.cluster as tcl

from repro_torch import ExecConfig, Session
from repro_torch.runtime.mesh_exec import validate_stage_decomposition
from torch_conformance import MESH_PLANS, MODEL_TEST_KW, check_mesh, model, \
    plans

DAGS = ["inception", "resnet101", "resnet18"]


@pytest.mark.parametrize("kind", MESH_PLANS)
@pytest.mark.parametrize("name", DAGS)
def test_mesh_matches_jax_session(name, kind):
    check_mesh(name, kind)


@pytest.mark.parametrize("name", sorted(MODEL_TEST_KW))
def test_stage_structure_matches_the_simulator(name):
    """instrument=True, overlap=False at 4 nodes: the measured (kind,
    label) stages equal the simulator's one to one, and every compute
    stage carries each node's completion time."""
    gj, wj, gt, wt, x = model(name)
    pj, pt, nodes = plans(gj, "search-n4")
    out, st = Session(gt, wt, pt, nodes, ExecConfig(
        executor="mesh", instrument=True, overlap=False,
        device="cpu")).run(torch.from_numpy(x))
    v = validate_stage_decomposition(
        st, build_stages(gj, pj, homogeneous(4, bandwidth_gbps=0.5)))
    assert v["structure_match"], (v["missing"], v["extra"])
    comp = [s for s in st.stage_times if s.kind == "compute"]
    assert comp and all(len(s.device_done_s) == 4 for s in comp)
    assert all(0.0 <= d <= s.wall_s for s in comp for d in s.device_done_s)


@pytest.mark.parametrize("name", sorted(MODEL_TEST_KW))
def test_stage_structure_matches_the_ports_simulator(name):
    """The port's ``build_stages`` equals the reference's stage for stage
    on the searched plans at 2, 4 and 8 nodes, and the measured mesh run
    validates against both."""
    gj, wj, gt, wt, x = model(name)
    for kind in ("search-n2", "search-n4", "search-n8"):
        pj, pt, nodes = plans(gj, kind)
        jc = homogeneous(nodes, bandwidth_gbps=0.5)
        tc = tcl.homogeneous(nodes, bandwidth_gbps=0.5)
        mine = tcl.build_stages(gt, pt, tc)
        ref = build_stages(gj, pj, jc)
        assert [(s.kind, s.durations, s.deps, s.label) for s in mine] == \
            [(s.kind, s.durations, s.deps, s.label) for s in ref]
        out, st = Session(gt, wt, pt, nodes, ExecConfig(
            executor="mesh", instrument=True, overlap=False,
            device="cpu")).run(torch.from_numpy(x))
        for stages in (mine, ref):
            v = validate_stage_decomposition(st, stages)
            assert v["structure_match"], (kind, v["missing"], v["extra"])
