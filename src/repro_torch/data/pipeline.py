"""Synthetic LM data pipeline: a copy of the JAX package's
``data/pipeline.py``, so its numpy batches are bit-equal to the reference's
for every (seed, step, host).

Deterministic, seekable token stream (numpy PRNG keyed by (seed, step)) so
every host in a multi-host launch can materialize its own shard of the
global batch without communication: host h takes rows
``[h*B/nhosts, (h+1)*B/nhosts)`` of the global batch — the standard
data-parallel input pattern.  Tokens follow a Zipfian distribution with a
Markov bigram structure, so the training loss has real signal to descend.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    def __post_init__(self) -> None:
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.n_hosts} hosts")
        rng = np.random.default_rng(self.seed + 12345)
        # fixed Zipf unigram + low-rank bigram mixing table
        ranks = np.arange(1, self.vocab + 1)
        self._unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._shift = rng.integers(1, self.vocab, size=(257,))

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.n_hosts

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Local shard of the global batch for ``step`` (seekable)."""
        rng = np.random.default_rng(
            (self.seed, step, self.host_id, 0xBEEF))
        b = self.local_batch
        toks = rng.choice(self.vocab, size=(b, self.seq_len + 1),
                          p=self._unigram).astype(np.int32)
        # Markov structure: token[t+1] correlates with token[t]
        mask = rng.random((b, self.seq_len)) < 0.5
        nxt = (toks[:, :-1] + self._shift[toks[:, :-1] % 257]) % self.vocab
        toks[:, 1:] = np.where(mask, nxt, toks[:, 1:])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_batch_specs(cfg, seq_len: int, global_batch: int,
                     *, mode: str = "train") -> Dict[str, torch.Tensor]:
    """Stand-ins for every model input: tensors on the ``meta`` device,
    which carry shape and dtype and allocate nothing (the counterpart of
    the reference's ``ShapeDtypeStruct``s)."""
    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    i32 = torch.int32
    if mode == "decode":
        return {"tokens": spec((global_batch, 1), i32)}
    out = {"tokens": spec((global_batch, seq_len), i32)}
    if mode == "train":
        out["labels"] = spec((global_batch, seq_len), i32)
    dt = getattr(torch, cfg.dtype)
    if cfg.family == "vlm":
        out["vision_embeds"] = spec(
            (global_batch, cfg.vision_tokens, cfg.d_model), dt)
    if cfg.family == "encdec":
        out["audio_embeds"] = spec((global_batch, cfg.enc_seq, cfg.d_model),
                                   dt)
    return out
