"""The one traffic generator: a mix's parameters and a run's seed give the
run's requests.

A mix is a JSON file ``bench/traffic/<name>.json``:

* ``loop``: ``"closed"``, the one kind so far: ``clients`` callers (1), each
  sending its next request when the last one has returned;
* ``batch``: sequences a request serves together;
* ``prompt_len``, ``gen_len``: ``[lo, hi]`` tokens of each sequence's
  prompt and of what it generates;
* ``sizes``: how many (prompt, generation) pairs the mix holds.  They are
  spread evenly over both ranges (both ends included) and paired by a
  fixed permutation, so every seed sends the same set of sizes, each seed
  in its own order (a fresh order each time the set is used up);
* ``capacity``: optional, the cache a session is made with (else each
  request's own prompt plus generation).

The seed draws the order of the sizes and the token ids of every prompt,
each request's from a seed of its own, so request ``i`` is the same
whatever ran before it.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    batch: int
    prompt_len: int
    gen_len: int
    seed: int          # the request's own seed: its prompts' token ids

    @property
    def steps(self) -> int:
        """Decode steps of each sequence: the prompt is fed through the
        decode step too."""
        return self.prompt_len + self.gen_len


def load(name: str, directory: Path = TRAFFIC_DIR) -> Dict:
    return json.loads((directory / f"{name}.json").read_text())


def _spread(lo_hi, n: int) -> List[int]:
    lo, hi = int(lo_hi[0]), int(lo_hi[1])
    if n == 1 or lo == hi:
        return [hi] * n
    return [lo + round((hi - lo) * k / (n - 1)) for k in range(n)]


def sizes(mix: Dict) -> List[Tuple[int, int]]:
    """The mix's (prompt, generation) pairs, the same for every seed."""
    n = int(mix["sizes"])
    prompts = _spread(mix["prompt_len"], n)
    gens = _spread(mix["gen_len"], n)
    pair = np.random.default_rng(0).permutation(n)
    return [(prompts[k], gens[int(pair[k])]) for k in range(n)]


def seed_of(seed: int, *key: int) -> int:
    """A seed of its own for each use of the run's seed (``key``)."""
    ss = np.random.SeedSequence(int(seed), spawn_key=tuple(key))
    hi, lo = ss.generate_state(2, np.uint32)
    return (int(hi) << 31) ^ int(lo)       # below 2**63: a torch seed


def requests(mix: Dict, seed: int) -> Iterator[Request]:
    """The run's requests, in the order they are sent (endless: the window
    takes as many as it has time for)."""
    if mix.get("loop") != "closed" or int(mix.get("clients", 1)) != 1:
        raise ValueError(f"unsupported loop {mix.get('loop')!r} of "
                         f"{mix.get('clients')} clients")
    pairs = sizes(mix)
    index, cycle = 0, 0
    while True:
        order = np.random.default_rng(seed_of(seed, 0, cycle)).permutation(
            len(pairs))
        for k in order:
            p, g = pairs[int(k)]
            yield Request(index, int(mix["batch"]), p, g,
                          seed_of(seed, 1, index))
            index += 1
        cycle += 1


def longest(mix: Dict) -> Tuple[int, int]:
    """The pair of the most steps."""
    return max(sizes(mix), key=lambda pg: pg[0] + pg[1])


def prompt_ids(req: Request, vocab: int, device) -> "torch.Tensor":
    """``[batch, prompt_len]`` int64 token ids below ``vocab``, drawn on
    ``device`` from the request's seed."""
    import torch
    gen = torch.Generator(device=device).manual_seed(req.seed)
    return torch.randint(0, vocab, (req.batch, req.prompt_len),
                         generator=gen, device=device)
