"""The comparison that decides ``correct``: what the timed window served,
against the plain reference run once over each sampled sequence.

A sample is one served sequence: its tokens as served (the prompt, then
the tokens the program generated and fed back), the positions at which
the program gave logits, those logits, and which of them chose a served
token.  The reference reads the same tokens (teacher forcing), so a
position's reference logits are what the program should have computed
there, whatever it chose before.  Two numbers, each in units of the
reference logits' standard deviation at the position, so they read alike
at any logit scale:

* ``token_gap``: the widest gap by which a served token's logit, as the
  program gave it, lies below the reference's best logit at its
  position.  Greedy decoding serves the program's argmax, whose logit a
  correct program puts at the reference's best within rounding; a token
  altered after it was chosen, or chosen from logits that are off, lies
  below it by more;
* ``logit_err``: the largest difference between a logit of the program's
  and the reference's.

The control (``control_numbers``) puts the reference computed in a lower
precision in the program's place: its logits at the same positions, and
the token it puts first at each position where the program served one,
with that token's logit as the lower precision gives it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Sequence

import torch

NAMES = ("token_gap", "logit_err")


@dataclasses.dataclass
class Sample:
    tokens: torch.Tensor      # [S] int64: prompt, then served tokens
    positions: torch.Tensor   # [n] int64: positions the logits are of
    logits: torch.Tensor      # [n, V]: the program's logits there
    served: torch.Tensor      # [m] int64: rows of ``logits`` that chose
    #                           the token after their position


def _numbers(ref: torch.Tensor, logits: torch.Tensor, chosen: torch.Tensor,
             rows: torch.Tensor) -> Dict[str, float]:
    std = ref.std(dim=-1)
    err = ((logits.float() - ref).abs().amax(dim=-1) / std).max()
    got = logits[rows].float().gather(1, chosen[:, None])[:, 0]
    gap = (ref[rows].amax(dim=-1) - got) / std[rows]
    return {"token_gap": float(gap.max()) if len(rows) else 0.0,
            "logit_err": float(err)}


def _merge(acc: Dict[str, float], new: Mapping[str, float]) -> None:
    for k, v in new.items():
        acc[k] = max(acc.get(k, 0.0), v)


def program_numbers(samples: Sequence[Sample],
                    reference: Callable) -> Dict[str, float]:
    """The program's numbers over ``samples``; ``reference(tokens,
    positions)`` gives f32 logits ``[n, V]``."""
    out: Dict[str, float] = {}
    for s in samples:
        ref = reference(s.tokens, s.positions)
        chosen = s.tokens[s.positions[s.served] + 1]
        _merge(out, _numbers(ref, s.logits, chosen, s.served))
        del ref
    return out


def control_numbers(samples: Sequence[Sample], reference: Callable,
                    control: Callable) -> Dict[str, float]:
    """The control's numbers: ``control(tokens, positions)`` in the
    program's place, on the same tokens."""
    out: Dict[str, float] = {}
    for s in samples:
        ref = reference(s.tokens, s.positions)
        ctl = control(s.tokens, s.positions)
        chosen = ctl[s.served].argmax(dim=-1)
        _merge(out, _numbers(ref, ctl, chosen, s.served))
        del ref, ctl
    return out


def judge(numbers: Mapping[str, float],
          limits: Mapping[str, float]) -> List[Dict]:
    """Each compared number beside its limit; a number is within it when
    it is finite and at most the limit."""
    return [{"name": k, "value": numbers[k], "limit": limits[k],
             "ok": numbers[k] == numbers[k] and numbers[k] <= limits[k]}
            for k in limits]
