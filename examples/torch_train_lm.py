"""End-to-end example on the PyTorch/CUDA port: train a ~100M-parameter LM
for a few hundred steps.

The counterpart of ``examples/train_lm.py``, on the port's full substrate:
synthetic data pipeline, AdamW + cosine schedule, remat'd blocks (each
under non-reentrant activation checkpointing), self-attention through the
hand-written flash kernel, checkpointing to the reference's pytree; the
step is one captured program (``capture_train_step``: one CUDA graph a
step on the card), as the reference jits its step.  One
process on one device: ``--devices N`` with ``N > 1`` (the reference's
data parallelism over fake CPU devices) raises, since a mesh over several
cards is ROADMAP A 10.  The weights are drawn from torch's generator
(seed 0), so the losses differ from the JAX example's.  Runs on the card;
``--device cpu`` trains on the CPU.

Run:  PYTHONPATH=src python examples/torch_train_lm.py --steps 300 \\
          [--device cpu]
"""
import argparse
import math
import os
import sys
import tempfile
import time

import torch

from repro_torch.checkpoint import save_pytree
from repro_torch.configs.base import ModelConfig
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch import require_device
from repro_torch.models.transformer import Model, params_to_numpy
from repro_torch.optim import adamw_init
from repro_torch.runtime.steps import capture_train_step


#: ~100M params: 12L x d768 (GQA 12h/4kv), vocab 32k
CONFIG = dict(name="lm-100m", family="dense", n_layers=12, d_model=768,
              n_heads=12, n_kv=4, d_ff=2048, vocab=32000, dtype="float32")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_lm.npz"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.devices > 1:
        raise NotImplementedError(
            f"--devices {args.devices}: data parallelism over several "
            f"devices is not ported (ROADMAP A 10, a mesh over several "
            f"cards); run with --devices 1")
    dev = require_device(args.device)

    cfg = ModelConfig(**CONFIG)
    model = Model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params / 1e6:.1f}M params on {dev.type}")

    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=args.seq,
                            global_batch=args.batch, seed=0)
    opt = adamw_init(dict(model.named_parameters()))
    step_fn = None

    t0 = time.time()
    losses = []
    for i, b in zip(range(args.steps), ds):
        batch = {k: torch.from_numpy(v).long().to(dev) for k, v in b.items()}
        if step_fn is None:
            step_fn = capture_train_step(model, opt, batch, peak_lr=3e-4,
                                         warmup=20, total=args.steps)
        opt, metrics = step_fn(model, opt, batch)
        losses.append(float(metrics["loss"]))
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={losses[-1]:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"({(time.time() - t0):.1f}s)")
    save_pytree(params_to_numpy(model), args.ckpt)
    print(f"checkpoint -> {args.ckpt}")
    final = losses[-1]
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"non-finite loss: {losses}")
    print(f"final loss {final:.4f} (start ~{math.log(cfg.vocab):.2f})")
    return 0 if final < 9.5 else 1


if __name__ == "__main__":
    sys.exit(main())
