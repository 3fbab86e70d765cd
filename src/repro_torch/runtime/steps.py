"""Step functions of the LM substrate: train, prefill and decode (the port
of the JAX package's ``runtime/steps.py``), and the decode and train steps
as captured programs (:func:`capture_decode_step`,
:func:`capture_train_step`), the counterparts of the reference launchers'
``jax.jit(model.decode_step)`` and ``jax.jit(make_train_step(...))``.

The step functions are plain calls on the
:class:`~repro_torch.models.transformer.Model`, whose weights are its
module state: eager, a Python call per op.  A captured program runs such a
step on the card as one :class:`~repro_torch.runtime.graphs.GraphProgram`
per shape: its first call runs the step eagerly (the warm-up), its second
captures the step as one CUDA graph and replays it, every later call
replays it.  The step's changing inputs live in the program's own device
tensors (the token and the position; the batch), and what the step
updates (the cache; the weights, the moments and the step counter) it
updates in place, so a replay leaves them where the next replay reads
them.  On CPU tensors a program runs its step eagerly on those same
inputs: the caller's choice of device, as with the kernel wrappers.  On
the card it captures or raises; nothing falls back to the eager step,
which stays reachable as ``model.decode_step`` and
:func:`make_train_step`'s step.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..models.transformer import Model
from ..optim import adamw_update, cosine_schedule
from .graphs import GraphProgram


def loss_and_grads(model: Model, batch: Dict[str, torch.Tensor], *,
                   accum: int = 1) -> Tuple[torch.Tensor,
                                            Dict[str, torch.Tensor]]:
    """The loss (``model.loss`` with ``remat``) and the gradient of every
    parameter that requires one, by name.  ``accum > 1`` splits the batch
    on its leading axis as the reference does (rows ``i::accum`` make
    microbatch ``i``, so each draws evenly from every data shard), sums
    the microbatches' losses and gradients in f32 buffers (the
    reference's ``scan`` carry) and divides by ``accum``: the gradients
    are then f32, else in each parameter's dtype.  A parameter the loss
    does not reach gets zeros, as ``jax.grad`` gives."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    if not named:
        raise ValueError("no parameter requires a gradient: call "
                         "model.requires_grad_(True) (make_train_step does)")
    names, params = zip(*named)

    def grads_of(b):
        loss = model.loss(b, remat=True)
        gs = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(params, gs)]

    if accum == 1:
        loss, gs = grads_of(batch)
        return loss, dict(zip(names, gs))
    rows = batch["tokens"].shape[0]
    if accum < 1 or rows % accum:
        raise ValueError(f"accum {accum} does not divide the batch of "
                         f"{rows} rows")
    loss_acc = torch.zeros((), dtype=torch.float32, device=model.device)
    g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in params]
    for i in range(accum):
        loss, gs = grads_of({k: v[i::accum] for k, v in batch.items()})
        loss_acc += loss
        for acc, g in zip(g_acc, gs):
            acc += g
    return loss_acc / accum, {n: g / accum for n, g in zip(names, g_acc)}


def make_train_step(model: Model, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total: int = 10_000,
                    accum: int = 1):
    """``train_step(model, opt_state, batch) -> (opt_state, {"loss",
    "lr"})``: :func:`loss_and_grads`, the cosine schedule at the
    optimizer's step, then AdamW, the model's weights and ``opt_state``
    (``optim.adamw_init`` of its named parameters) updated in place.
    ``accum > 1`` runs gradient accumulation over microbatches, cutting
    peak activation memory about ``accum`` times.  Turns on the gradients
    of ``model``'s parameters, which it creates frozen."""
    model.requires_grad_(True)

    def train_step(model: Model, opt_state: Dict[str, Any],
                   batch: Dict[str, torch.Tensor]):
        loss, grads = loss_and_grads(model, batch, accum=accum)
        lr = cosine_schedule(opt_state["step"], peak_lr=peak_lr,
                             warmup=warmup, total=total)
        _, opt_state = adamw_update(grads, opt_state,
                                    dict(model.named_parameters()), lr)
        return opt_state, {"loss": loss, "lr": lr}
    return train_step


def make_prefill_step(model: Model):
    def prefill_step(batch):
        return model.prefill(batch)
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(cache, tok, t):
        return model.decode_step(cache, tok, t)
    return decode_step


class _EagerProgram:
    """:class:`~repro_torch.runtime.graphs.GraphProgram`'s calling
    convention on the CPU: each call copies its arguments into the
    program's tensors and runs ``fn`` on them eagerly."""

    def __init__(self, fn, *inputs: torch.Tensor):
        self.fn, self.inputs = fn, inputs

    def __call__(self, *args: torch.Tensor):
        for dst, src in zip(self.inputs, args):
            if src is not dst:
                dst.copy_(src)
        return self.fn(*self.inputs)


def _program(fn, *inputs: torch.Tensor):
    """``fn`` on its own input tensors: captured on the card, eager on the
    CPU (the inputs' device decides)."""
    cls = GraphProgram if inputs[0].device.type == "cuda" else _EagerProgram
    return cls(fn, *inputs)


class DecodeProgram:
    """``model.decode_step`` on one cache as one program: the token ``[B,
    1]`` and the position (a 0-d int32) live in the program's device
    tensors, the cache is updated in place.  Called as the step is,
    ``program(cache, tok, t) -> (logits [B, 1, V], cache)`` with the cache
    it was made on and a host int ``t``, which it checks (the port's
    bounds, :meth:`Model.check_position`) before the step runs.  The
    logits are the program's: the next call overwrites them."""

    def __init__(self, model: Model, cache: Dict[str, Any], batch: int):
        dev = model.device
        self.model, self.cache = model, cache
        self.tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)
        self.pos = torch.zeros((), dtype=torch.int32, device=dev)

        self.program = _program(
            lambda tok, pos: model.decode_step(cache, tok, pos)[0],
            self.tok, self.pos)

    def __call__(self, cache, tok: torch.Tensor, t: int):
        if cache is not self.cache:
            raise ValueError("a decode program runs on the cache it was "
                             "made on")
        self.model.check_position(cache, t)
        self.pos.fill_(t)
        return self.program(tok, self.pos), cache


def capture_decode_step(model: Model, cache: Dict[str, Any],
                        batch: int) -> DecodeProgram:
    """The decode step on ``cache`` (``model.cache_init(batch, capacity)``,
    an encoder-decoder's ``xlayers`` filled before the first call) as one
    program for its batch and capacity: on the card a
    :class:`~repro_torch.runtime.graphs.GraphProgram` captured at its
    second call, on the CPU the eager step on the program's tensors."""
    return DecodeProgram(model, cache, batch)


class TrainProgram:
    """:func:`make_train_step`'s step on one model, optimizer state and
    batch shape as one program: the batch lives in the program's device
    tensors; the weights, the moments and the step counter are updated in
    place.  Called as the step is, ``program(model, opt_state, batch) ->
    (opt_state, {"loss", "lr"})``, with the model and state it was made on
    and a batch of the same keys, shapes and dtypes.  The metrics are the
    program's 0-d tensors: read them before the next call, which
    overwrites them."""

    def __init__(self, model: Model, opt_state: Dict[str, Any],
                 batch: Dict[str, torch.Tensor], **step_kw):
        self.model, self.opt_state = model, opt_state
        step = make_train_step(model, **step_kw)
        self.keys = tuple(batch)
        self.inputs = tuple(batch[k].to(model.device, copy=True)
                            for k in self.keys)

        def body(*tensors):
            _, m = step(model, opt_state, dict(zip(self.keys, tensors)))
            return m["loss"], m["lr"]
        self.program = _program(body, *self.inputs)

    def __call__(self, model: Model, opt_state: Dict[str, Any],
                 batch: Dict[str, torch.Tensor]):
        if model is not self.model or opt_state is not self.opt_state:
            raise ValueError("a train program runs on the model and the "
                             "optimizer state it was made on")
        if tuple(batch) != self.keys or any(
                batch[k].shape != x.shape or batch[k].dtype != x.dtype
                for k, x in zip(self.keys, self.inputs)):
            raise ValueError("a train program takes batches of its own "
                             "keys, shapes and dtypes: " + str({
                                 k: (tuple(x.shape), x.dtype) for k, x in
                                 zip(self.keys, self.inputs)}))
        loss, lr = self.program(*(batch[k] for k in self.keys))
        return opt_state, {"loss": loss, "lr": lr}


def capture_train_step(model: Model, opt_state: Dict[str, Any],
                       batch: Dict[str, torch.Tensor], *,
                       peak_lr: float = 3e-4, warmup: int = 100,
                       total: int = 10_000, accum: int = 1) -> TrainProgram:
    """:func:`make_train_step` with these arguments as one program for
    ``batch``'s shape (batch, sequence) and ``accum``, the accumulation
    loop inside it: on the card a
    :class:`~repro_torch.runtime.graphs.GraphProgram` captured at its
    second call (the checkpointed forward, ``torch.autograd.grad``, the
    schedule and AdamW in the one graph), on the CPU the eager step on the
    program's tensors.  ``batch`` gives the shape; each call's batch is
    copied in."""
    return TrainProgram(model, opt_state, batch, peak_lr=peak_lr,
                        warmup=warmup, total=total, accum=accum)
