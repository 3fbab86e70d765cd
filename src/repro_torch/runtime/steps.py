"""Step functions of the LM substrate: train, prefill and decode (the port
of the JAX package's ``runtime/steps.py``).

The reference lowers these for its launcher and dry-run; here they are
plain calls on the :class:`~repro_torch.models.transformer.Model`, whose
weights are its module state.  A train step is eager, a Python call per op
(the reference jits it; one captured CUDA graph a step is an open item).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..models.transformer import Model
from ..optim import adamw_update, cosine_schedule


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
