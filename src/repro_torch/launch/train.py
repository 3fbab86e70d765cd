"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--steps N] [--batch B] [--seq S] [--accum A] [--full] [--ckpt PATH]
[--device cuda|cpu] [--dtype DTYPE] [--dry-run [--shape SHAPE]]``.

The port of the JAX package's ``launch/train.py``: real optimizer steps of
one registry architecture (its ``reduced()`` variant unless ``--full``) on
one device, with random weights from a ``torch.Generator`` seeded 0 (as
serving makes them) and batches from ``SyntheticLMDataset(seed=0)``; a vlm
gets zero vision embeddings and an encdec zero audio embeddings, as in the
reference.  The schedule warms up over a tenth of the steps and ends at
``--steps``.  Logs ``train.start``, ``train.step`` and ``train.checkpoint``
through :mod:`repro_torch.obs.log` (``REPRO_LOG``); ``--ckpt`` writes the
trained weights as the reference's pytree (``params_to_numpy``) with
``save_pytree``.  Runs on the card unless ``--device cpu``; the step is
eager (one captured graph a step is an open item).  ``--dtype float32``
trains a bf16 config in f32.  ``--dry-run`` counts the production-mesh
step of ``--shape`` (default ``train_4k``) without running it, through
:func:`repro_torch.launch.dryrun.main`.

:func:`main` returns a :class:`TrainResult` (losses, learning rates, each
step's wall with the card synchronised, peak device memory), or with
``--dry-run`` the dry run's records.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import List

import torch

from ..checkpoint import save_pytree
from ..configs.registry import get_config
from ..data import SyntheticLMDataset
from ..models.transformer import Model, params_to_numpy
from ..obs.log import log
from ..optim import adamw_init
from ..runtime.steps import make_train_step


@dataclasses.dataclass
class TrainResult:
    """What one training run made: the trained model and its optimizer
    state, each step's loss and learning rate (floats read after the
    step), each step's host-clock wall in ms (the device synchronised
    before and after), the tokens a step, the parameter count and the peak
    device memory in bytes (None on the CPU)."""
    model: Model
    opt_state: dict
    losses: List[float]
    lrs: List[float]
    step_ms: List[float]
    tokens_per_step: int
    n_params: int
    peak_bytes: int | None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--full", action="store_true",
                    help="full config (default: reduced smoke variant)")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None,
                    help="parameter and activation dtype (default: the "
                         "config's)")
    args = ap.parse_args(argv)

    if args.dry_run:
        from . import dryrun
        return dryrun.main(["--arch", args.arch, "--shape", args.shape])

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    dev = torch.device(args.device)
    model = Model(cfg, device=dev)          # raises on "cuda" with no card
    model.init(torch.Generator(device=dev).manual_seed(0))
    n = sum(p.numel() for p in model.parameters())
    log("train.start", arch=cfg.name, params_m=n / 1e6, devices=1)

    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=args.seq,
                            global_batch=args.batch, seed=0)
    step = make_train_step(model, total=args.steps,
                           warmup=max(1, args.steps // 10),
                           accum=args.accum)
    opt = adamw_init(dict(model.named_parameters()))
    dt = getattr(torch, cfg.dtype)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, lrs, walls = [], [], []
    t0 = time.time()
    for i, b in zip(range(args.steps), ds):
        batch = {k: torch.from_numpy(v).long().to(dev) for k, v in b.items()}
        if cfg.family == "vlm":
            batch["vision_embeds"] = torch.zeros(
                (args.batch, cfg.vision_tokens, cfg.d_model), dtype=dt,
                device=dev)
        if cfg.family == "encdec":
            batch["audio_embeds"] = torch.zeros(
                (args.batch, cfg.enc_seq, cfg.d_model), dtype=dt, device=dev)
        _sync(dev)
        ts = time.perf_counter()
        opt, m = step(model, opt, batch)
        _sync(dev)
        walls.append((time.perf_counter() - ts) * 1e3)
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
        if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
            log("train.step", step=i, loss=losses[-1],
                elapsed_s=time.time() - t0)
    if args.ckpt:
        save_pytree(params_to_numpy(model), args.ckpt)
        log("train.checkpoint", path=args.ckpt)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    return TrainResult(model, opt, losses, lrs, walls, args.batch * args.seq,
                       n, peak)


if __name__ == "__main__":
    main()
    sys.exit(0)
