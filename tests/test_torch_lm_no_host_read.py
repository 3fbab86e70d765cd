"""No LM step reads the device to the host or makes a tensor from host
data: what a captured step (``runtime.steps.capture_decode_step``,
``capture_train_step``) needs, checked on CPU tensors.

A capture fails on the card at a host read (``.item()``, ``bool()`` of a
tensor, indexing by a boolean mask, ``nonzero``) and freezes a tensor made
from host data into the graph.  :class:`NoHostRead` is a dispatch mode
that raises on both: on the aten ops that read a tensor's value to the
host, on indexing by a boolean tensor, on ``lift_fresh`` (``torch.tensor``
and ``torch.as_tensor`` of host data), and on any op whose tensor
argument was neither given to the step (weights, cache, optimizer state,
the program's inputs) nor made by an op inside it (a tensor from
``torch.from_numpy`` or a module-level constant).  It runs over the
program decode step of all ten registry archs and their train step at
``accum`` 1 and 2, and catches its negative cases.

The paged decode kernel reads its live length from device memory on the
card; its plain version, which the wrapper runs on CPU tensors, reads an
int.  So here ``repro_torch.models.attention.flash_decode_paged`` is the
plain version's form for a device length (``kernels.ref._decode_masked``:
every page, the dead keys masked), the function the card's kernel
computes without a host read.
"""
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch.models.attention as lm_attn
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.kernels.ref import _decode_masked
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.runtime.steps import capture_decode_step, capture_train_step

from torch_lm_cases import batches, one_intra_op_thread  # noqa: F401

aten = torch.ops.aten

#: ops that read a tensor's value to the host
HOST_READS = {aten._local_scalar_dense, aten.item, aten.is_nonzero,
              aten.equal, aten.nonzero, aten.nonzero_static, aten.argwhere,
              aten.masked_select, aten.bincount, aten._unique2,
              aten.unique_consecutive, aten.unique_dim}
#: ops that make a tensor from host data
HOST_MADE = {aten.lift_fresh, aten.lift_fresh_copy}
#: ops that read a boolean index on the host (the CPU kernel does it
#: inside ``index``; on the card it is a ``nonzero`` and a sync)
INDEXING = {aten.index, aten.index_put, aten.index_put_,
            aten._index_put_impl_}


class HostRead(AssertionError):
    pass


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def _ptr(t):
    return t.untyped_storage().data_ptr()


class NoHostRead(TorchDispatchMode):
    """Raises :class:`HostRead` at a host read or a tensor from host data
    inside the ``with`` block; ``known`` are the step's given tensors
    (any nesting of lists, tuples and dicts).  ``ops`` counts the ops
    seen, ``names`` their names."""

    def __init__(self, *known):
        super().__init__()
        self.known = {_ptr(t) for t in _tensors(known)}
        self.made = []          # the storages made inside: kept alive, so
        self.ops = 0            # no later tensor takes a known address
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet in HOST_READS:
            raise HostRead(f"{func} reads a tensor to the host")
        if packet in HOST_MADE:
            raise HostRead(f"{func}: a tensor made from host data")
        if packet in INDEXING and any(
                i is not None and i.dtype == torch.bool for i in args[1]):
            raise HostRead(f"{func} indexes by a boolean mask")
        for t in _tensors((args, kwargs)):
            if t.numel() and _ptr(t) not in self.known:
                raise HostRead(f"{func} reads a {tuple(t.shape)} "
                               f"{t.dtype} tensor made outside the step")
        out = func(*args, **kwargs)
        for t in _tensors(out):
            self.known.add(_ptr(t))
            self.made.append(t.untyped_storage())
        self.ops += 1
        self.names.add(str(packet))
        return out


@pytest.fixture
def device_length_decode(monkeypatch):
    """The decode kernel as the card runs it: its length read where it
    lies (the plain version's form for a device ``kv_len``)."""
    def decode(q, kp, vp, table, kv_len, *, window=None, scale=None,
               groups=1):
        assert isinstance(kv_len, torch.Tensor) and kv_len.dtype == \
            torch.int32
        return _decode_masked(q, kp, vp, table, kv_len.reshape(()), window,
                              scale, groups)
    monkeypatch.setattr(lm_attn, "flash_decode_paged", decode)


def _config(arch, **kw):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              **kw)
    if cfg.family == "vlm" and "vision_tokens" not in kw:
        cfg = dataclasses.replace(cfg, vision_tokens=0)
    return cfg


CASES = [(a, {}) for a in ARCH_IDS] + [("llama3-8b", {"attn_window": 4})]


@pytest.mark.parametrize("arch,kw", CASES,
                         ids=[a + ("-window" if kw else "") for a, kw in CASES])
def test_decode_program_reads_nothing_to_the_host(arch, kw,
                                                  device_length_decode):
    """Prompt and greedy steps through the program, the argmax between
    them; the windowed case wraps its ring buffer of 4."""
    cfg = _config(arch, **kw)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    _, tb = batches(cfg, s=3, seed=1)
    steps = 7
    cache = model.cache_init(2, cfg.attn_window or steps)
    if cfg.family == "encdec":
        cache["xlayers"] = model.encode_cross(tb["audio_embeds"])
    prog = capture_decode_step(model, cache, 2)
    guard = NoHostRead(list(model.parameters()), cache, tb["tokens"],
                       prog.tok, prog.pos)
    leaves = [id(t) for t in _tensors(cache)]
    with guard:
        for t in range(steps):
            tok = tb["tokens"][:, t:t + 1] if t < 3 else \
                torch.argmax(logits[:, -1], dim=-1, keepdim=True)
            logits, cache = prog(cache, tok, t)
    assert guard.ops > 0
    assert bool(torch.isfinite(logits).all())
    # every cache entry was written in place, none rebound
    assert [id(t) for t in _tensors(cache)] == leaves


TRAIN = [(a, 1) for a in ARCH_IDS] + [(a, 2) for a in ARCH_IDS]


@pytest.mark.parametrize("arch,accum", TRAIN)
def test_train_program_reads_nothing_to_the_host(arch, accum):
    """Two steps through the program: the checkpointed forward, the
    backward, the schedule and AdamW (a vlm with its vision tokens, an
    encdec with its audio)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(2))
    _, tb = batches(cfg, b=4, s=8, seed=2)
    opt = adamw_init(dict(model.named_parameters()))
    prog = capture_train_step(model, opt, tb, warmup=1, total=4,
                              accum=accum)
    guard = NoHostRead(list(model.parameters()), opt, tb, prog.inputs)
    leaves = [id(t) for t in _tensors((list(model.parameters()), opt))]
    losses = []
    for _ in range(2):
        with guard:
            opt, m = prog(model, opt, tb)
        losses.append(float(m["loss"]))
    assert int(opt["step"]) == 2
    assert [id(t) for t in _tensors((list(model.parameters()), opt))] \
        == leaves
    # the backward ran under the mode
    assert any("backward" in n for n in guard.names), sorted(guard.names)
    assert all(torch.isfinite(torch.tensor(losses)))


@pytest.mark.parametrize("case", ["item", "bool", "mask", "tensor",
                                  "as_tensor", "from_numpy", "one_hot"])
def test_the_mode_catches_host_reads(case):
    import numpy as np
    x = torch.arange(6.0)
    with pytest.raises(HostRead):
        with NoHostRead(x):
            if case == "item":
                x.sum().item()
            elif case == "bool":
                bool((x > 2).any())
            elif case == "mask":
                x[x > 2]
            elif case == "tensor":
                x * torch.tensor(0.9)
            elif case == "as_tensor":
                x + torch.as_tensor(np.ones(6, np.float32))
            elif case == "from_numpy":
                x + torch.from_numpy(np.ones(6, np.float32))
            else:
                torch.nn.functional.one_hot(x.long(), 6)
    with NoHostRead(x) as guard:          # a step of ops on what it has
        y = torch.where(x > 2, x * 2.0, 0.0)
        y.index_put_((torch.arange(2),), y[:2] + 1)
    assert guard.ops > 0


def test_adamw_updates_its_state_in_place():
    """The step counter, the moments and the weights stay the same tensors
    and advance: the counter is k after k steps."""
    g = torch.Generator().manual_seed(5)
    params = {"a": torch.randn((3, 4), generator=g),
              "b": torch.randn((4,), generator=g)}
    state = adamw_init(params)
    step, m, v = state["step"], dict(state["m"]), dict(state["v"])
    ids = {n: p for n, p in params.items()}
    for k in range(1, 4):
        grads = {n: torch.randn(p.shape, generator=g)
                 for n, p in params.items()}
        before = {n: p.clone() for n, p in params.items()}
        lr = torch.tensor(1e-2)
        with NoHostRead(params, state, grads, lr):
            out, state2 = adamw_update(grads, state, params, lr)
        assert state2 is state and out is params
        assert state["step"] is step and int(step) == k
        assert step.dtype == torch.int32
        for n in params:
            assert state["m"][n] is m[n] and state["v"][n] is v[n]
            assert params[n] is ids[n]
            assert not torch.equal(params[n], before[n])
