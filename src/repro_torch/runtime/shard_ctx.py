"""Activation-sharding context: the mesh analogue of FlexPie's T boundaries
(the port of the JAX package's ``runtime/shard_ctx.py``).

Model code stays sharding-agnostic; the launcher installs a constraint
callback for the duration of a step, and blocks call :func:`constrain` at
their boundaries.  Sequence-sharded activations (the InH scheme) vs
batch-only sharding (leaving the model axis to weights, the OutC scheme) is
exactly the per-class decision the FCO planner makes.

The reference's callbacks are ``with_sharding_constraint`` calls that XLA
turns into re-layouts.  A tensor here lives on one card, so a callback
returns ``x`` unchanged; given ``record``, it reports ``(shape, spec)`` of
each re-layout point, which the dry run's op counter
(:mod:`repro_torch.launch.op_cost`) prices.  With no callback installed
:func:`constrain` is the identity.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional

from .shard_plan import P

_ACT_FN: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_act_fn", default=None)


@contextlib.contextmanager
def activation_sharding(fn: Optional[Callable]):
    tok = _ACT_FN.set(fn)
    try:
        yield
    finally:
        _ACT_FN.reset(tok)


def constrain(x):
    fn = _ACT_FN.get()
    return fn(x) if fn is not None else x


def _dpn(mesh, dp_axes) -> int:
    n = 1
    for a in dp_axes:
        n *= mesh.shape[a]
    return n


def seq_shard_fn(mesh, dp_axes, *, seq_axis: str = "model",
                 record: Optional[Callable] = None):
    """Constraint callback: [B, S, d] -> B over data axes, S over ``model``
    when divisible (best-effort; skips non-conforming streams)."""
    dpn = _dpn(mesh, dp_axes)
    m = mesh.shape[seq_axis]

    def fn(x):
        if x.ndim != 3:
            return x
        b, s, _ = x.shape
        spec = [None, None, None]
        if b % dpn == 0 and b > 1:
            spec[0] = dp_axes
        if s % m == 0 and s > 1:
            spec[1] = seq_axis
        if record is not None:
            record(tuple(x.shape), P(*spec))
        return x
    return fn


def batch_shard_fn(mesh, dp_axes, *, record: Optional[Callable] = None):
    """Constraint callback: batch over data axes only (TP-style)."""
    dpn = _dpn(mesh, dp_axes)

    def fn(x):
        if x.ndim != 3:
            return x
        b = x.shape[0]
        spec = [dp_axes if (b % dpn == 0 and b > 1) else None] \
            + [None] * (x.ndim - 1)
        if record is not None:
            record(tuple(x.shape), P(*spec))
        return x
    return fn
