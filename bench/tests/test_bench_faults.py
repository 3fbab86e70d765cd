"""``correct`` comes out false when the timed path is broken underneath:
a run of each tiny cell on the CPU (the harness's look for a chip
skipped, everything else as a run does it) with each fault the cell can
have planted in the program, and true with none.  And the control: the
reference in the step of precision below the configuration's, put in the
program's place, reads past the cell's limits."""
import pytest
import torch

from bench import compare, harness
from bench.tests.tiny_cells import run, tiny

SERVE = "olmo-1b.serve.short"
FLEXPIE = "flexpie-decode.mesh4.chat"
CELLS = [w["name"] for w in harness.load_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]]


class _ShiftedArgmax:
    """``torch`` with every argmax moved one token on: the token a step
    produces, altered where it is produced."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def argmax(*args, **kw):
        return (torch.argmax(*args, **kw) + 1) % 250


def _no_write(*args, **kw):
    """A cache write that writes nothing: the step leaves its state as it
    was."""


def _half_batch(decode_step):
    def step(self, cache, tok, t):
        logits, cache = decode_step(self, cache, tok, t)
        half = logits.shape[0] // 2
        logits[half:] = logits[:half]
        return logits, cache
    return step


def _drop_node_one(run_nodes):
    def nodes_run(self, *phases, marks=None):
        res = run_nodes(self, *phases, marks=marks)
        if len(res) > 1 and res[1] is not None:
            res[1] = torch.zeros_like(res[1])
        return res
    return nodes_run


def serve_fault(monkeypatch, fault):
    from repro_torch.launch import serve
    from repro_torch.models import attention
    from repro_torch.models.transformer import Model
    if fault == "token_altered":
        monkeypatch.setattr(serve, "torch", _ShiftedArgmax())
    elif fault == "state_unchanged":
        monkeypatch.setattr(attention, "write_slot", _no_write)
    elif fault == "half_batch":
        monkeypatch.setattr(Model, "decode_step",
                            _half_batch(Model.decode_step))


def flexpie_fault(monkeypatch, fault):
    from repro_torch.launch.mesh import NodesMesh
    from repro_torch.runtime import decode
    from repro_torch.runtime.kv_cache import PagedKVCache
    if fault == "token_altered":
        monkeypatch.setattr(decode, "torch", _ShiftedArgmax())
    elif fault == "state_unchanged":
        monkeypatch.setattr(PagedKVCache, "write", _no_write)
    elif fault == "exchange_left_out":
        monkeypatch.setattr(NodesMesh, "run", _drop_node_one(NodesMesh.run))


def _serve_cell():
    cell = tiny(SERVE)
    # three of the four rows: a fault in one half of the batch shows
    cell.spec = dict(cell.spec, check={"requests": 2, "sequences": 3})
    return cell


@pytest.mark.parametrize("fault", [None, "token_altered", "state_unchanged",
                                   "half_batch"])
def test_serving_cell_is_correct_only_when_sound(monkeypatch, fault):
    serve_fault(monkeypatch, fault)
    r = run(SERVE, cell=_serve_cell())
    assert r["correct"] is (fault is None), r["compared"]


@pytest.mark.parametrize("fault", [None, "token_altered", "state_unchanged",
                                   "exchange_left_out"])
def test_flexpie_cell_is_correct_only_when_sound(monkeypatch, fault):
    flexpie_fault(monkeypatch, fault)
    r = run(FLEXPIE, requests=3)
    assert r["correct"] is (fault is None), r["compared"]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_past_the_cells_limits(name, one_thread):
    """The reference in the configuration's ``control`` precision, on the
    prompts and tokens a tiny run served, fails at least one of the cell's
    limits; the program's own numbers there pass them all."""
    cell = tiny(name)
    if cell.config["driver"] == "serve_generate":
        cell = _serve_cell()
    drv = harness.driver_of(cell.config).Driver(
        cell.config, cell.mix, cell.spec["check"], 11, torch.device("cpu"))
    served, _ = harness.window(drv, cell.mix, 11, 0.0, 3, requests=3)
    drv.release()
    samples = drv.samples(harness.sampled(served))

    def control(tokens, positions):
        return drv.reference(tokens, positions, cell.config["control"])
    limits = cell.spec["limits"]
    program = compare.program_numbers(samples, drv.reference)
    ctl = compare.control_numbers(samples, drv.reference, control)
    assert all(c["ok"] for c in compare.judge(program, limits)), program
    assert not all(c["ok"] for c in compare.judge(ctl, limits)), ctl
