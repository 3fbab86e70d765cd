"""AdamW over named parameters: the port of the JAX package's
``optim/adamw.py``.

Moments are kept in f32 whatever the parameter's dtype; the global-norm
clip and the update are computed in f32 and the update is cast back to the
parameter's dtype (mixed-precision practice, as in the reference).  The
reference maps pure functions over pytrees and returns new parameters;
here the state holds dicts keyed by parameter name, and the parameters and
moments are updated in place (under ``no_grad``), which keeps one copy of
each on the card.  Not ``torch.optim.AdamW``: that keeps its moments in the
parameter's dtype (bf16 here) and applies the decay in another order.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch


def adamw_init(params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Zero f32 moments ``m`` and ``v`` for each named parameter and the
    int32 step counter, on the parameters' device."""
    f32 = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for n, p in params.items()}
    dev = next(iter(params.values())).device if params else None
    return {"m": f32, "v": {n: torch.zeros_like(t) for n, t in f32.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: Dict[str, Any],
                 params: Mapping[str, torch.Tensor], lr, *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 grad_clip: float = 1.0) -> Tuple[Mapping[str, torch.Tensor],
                                                  Dict[str, Any]]:
    """One AdamW step of every parameter named in ``params`` by its
    gradient in ``grads`` (the parameter's dtype or f32), the gradients
    first scaled so their global f32 norm is at most ``grad_clip``.  ``lr``
    is a float or a 0-d tensor.  Updates the parameters, ``state``'s
    moments and its step counter in place (the same tensors, so a captured
    step advances them on every replay; nothing is read to the host or
    made from host data) and returns ``(params, state)``."""
    state["step"].add_(1)
    # global-norm clip (fp32)
    gsq = sum(torch.sum(torch.square(grads[n].float())) for n in params)
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)

    stepf = state["step"].float()
    c1 = 1.0 - torch.pow(b1, stepf)
    c2 = 1.0 - torch.pow(b2, stepf)
    for n, p in params.items():
        g = grads[n].float() * scale
        m, v = state["m"][n], state["v"][n]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        mh = m / c1
        vh = v / c2
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, state
