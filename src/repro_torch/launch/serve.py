"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>
[--full] [--batch B] [--prompt-len P] [--gen N] [--device cuda|cpu]
[--dtype DTYPE] [--dry-run [--shape SHAPE]]``.

The port of the JAX package's ``launch/serve.py``: batched KV-cache decode
of one registry architecture (its ``reduced()`` variant unless ``--full``)
with random weights and prompts from seed 0, the prompt fed through
``decode_step`` token by token, then greedy generation; a vlm serves its
text stream (no vision tokens), an encdec fills its cross-attention cache
from stub audio first.  Logs ``serve.timing`` through
:mod:`repro_torch.obs.log` (``REPRO_LOG``).  Runs on the card unless
``--device cpu``.  On the card every step, prompt and generated, replays
one captured decode program for the batch and the cache's capacity
(:func:`repro_torch.runtime.steps.capture_decode_step`), as the
reference's launcher runs one ``jax.jit(model.decode_step)``; the greedy
argmax runs between replays.  ``--dtype float32`` serves a bf16 config
in f32 (the conformance tests' setting).  ``--dry-run`` counts the production-mesh
step of ``--shape`` (default ``decode_32k``) without running it, through
:func:`repro_torch.launch.dryrun.main`, and returns its records.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import List, Optional

import torch

from ..configs.registry import get_config
from ..models.transformer import Model
from ..obs.log import log
from ..runtime.steps import capture_decode_step


@dataclasses.dataclass
class ServeResult:
    """What one serve run made: the model, the prompts ``[B, P]``, the
    generated tokens ``[B, gen]``, each step's logits ``[B, V]`` (the
    prompt's steps first), and the host-clock walls (card synchronised):
    the prompt's steps (with a program's warm-up and capture) and the
    generated steps a token."""
    model: Model
    prompts: torch.Tensor
    tokens: torch.Tensor
    step_logits: List[torch.Tensor]
    prefill_ms: float
    decode_ms_per_token: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate(model: Model, prompts: torch.Tensor, n_gen: int,
             audio: Optional[torch.Tensor] = None, *,
             eager: bool = False) -> ServeResult:
    """Feed ``prompts`` through the decode step one position at a time,
    then generate ``n_gen`` tokens greedily, on a cache of exactly the
    positions it needs (the window's, where the config has one).  The step
    is one program for the batch and capacity
    (:func:`~repro_torch.runtime.steps.capture_decode_step`: captured on
    the card), or with ``eager`` ``model.decode_step`` itself, a Python
    call per op.  No autograd graph is built, whether or not the weights
    require gradients."""
    cfg, dev = model.cfg, model.device
    B, P = prompts.shape
    cache = model.cache_init(B, capacity=cfg.attn_window or (P + n_gen))
    if cfg.family == "encdec":
        cache["xlayers"] = model.encode_cross(audio)
    step = model.decode_step if eager else capture_decode_step(model,
                                                               cache, B)
    logits, step_logits = None, []
    _sync(dev)
    t0 = time.perf_counter()
    for t in range(P):
        logits, cache = step(cache, prompts[:, t:t + 1], t)
        step_logits.append(logits[:, -1].clone())
    tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
    _sync(dev)
    tp = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = []
    for i in range(n_gen):
        out.append(tok)
        logits, cache = step(cache, tok, P + i)
        step_logits.append(logits[:, -1].clone())
        tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
    _sync(dev)
    td = time.perf_counter() - t0
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"{cfg.name}: non-finite logits after decode")
    tokens = torch.cat(out, dim=1) if out else prompts[:, :0]
    return ServeResult(model, prompts, tokens, step_logits, tp * 1e3,
                       td * 1e3 / max(n_gen, 1))


def main(argv=None):
    """The CLI: a :class:`ServeResult`, or with ``--dry-run`` the dry
    run's records."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None,
                    help="parameter and activation dtype (default: the "
                         "config's)")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--shape", default="decode_32k")
    args = ap.parse_args(argv)

    if args.dry_run:
        from . import dryrun
        return dryrun.main(["--arch", args.arch, "--shape", args.shape])

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    if cfg.family == "vlm":
        cfg = dataclasses.replace(cfg, vision_tokens=0)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    dev = torch.device(args.device)
    model = Model(cfg, device=dev)          # raises on "cuda" with no card
    gen = torch.Generator(device=dev).manual_seed(0)
    model.init(gen)
    B, P = args.batch, args.prompt_len
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
    audio = None
    if cfg.family == "encdec":
        audio = torch.randn((B, cfg.enc_seq, cfg.d_model), generator=gen,
                            device=dev) * 0.02
    res = generate(model, prompts, args.gen, audio)
    log("serve.timing", arch=cfg.name, batch=B, prefill_ms=res.prefill_ms,
        decode_ms_per_token=res.decode_ms_per_token)
    return res


if __name__ == "__main__":
    main()
    sys.exit(0)
