"""Step functions of the LM substrate: prefill and decode (the port of the
JAX package's ``runtime/steps.py``).

The reference lowers these for its launcher and dry-run; here they are
plain calls on the :class:`~repro_torch.models.transformer.Model`, whose
weights are its module state.  ``make_train_step`` (gradients, the AdamW
update and the cosine schedule) comes with the training slice.
"""
from __future__ import annotations

from ..models.transformer import Model


def make_prefill_step(model: Model):
    def prefill_step(batch):
        return model.prefill(batch)
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(cache, tok, t):
        return model.decode_step(cache, tok, t)
    return decode_step
