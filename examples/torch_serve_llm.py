"""Serve a small model with batched requests on the PyTorch/CUDA port:
prefill + KV-cache decode.

The counterpart of ``examples/serve_llm.py``: batched prompts fed through
the decode step token by token (per-layer cache pages), then greedy
generation; on the card the step is one captured program
(``serve.generate``), as the reference jits its step.  The decode
attention runs through the hand-written paged decode kernel.  The example then runs the fused prefill over the prompts
(self-attention through the flash kernel) and checks that its last
position's logits agree with the decode-fed ones (but for MoE, whose
prefill drops the tokens past an expert's capacity).  The weights are drawn
from torch's generator (seed 0), so the tokens differ from the JAX
example's.  Runs on the card; ``--device cpu`` runs the kernels' plain
versions on the CPU.

Run:  PYTHONPATH=src python examples/torch_serve_llm.py --arch llama3-8b
      (reduced config; any of the 10 registry archs works) [--device cpu]
"""
import argparse
import dataclasses
import sys

import torch

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch import require_device
from repro_torch.launch.serve import generate
from repro_torch.models.transformer import Model


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    cfg = dataclasses.replace(get_config(args.arch).reduced(),
                              dtype="float32")
    if cfg.family == "vlm":
        cfg = dataclasses.replace(cfg, vision_tokens=0)
    model = Model(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    model.init(gen)

    B, P = args.batch, args.prompt_len
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
    audio = None
    if cfg.family == "encdec":
        audio = torch.randn((B, cfg.enc_seq, cfg.d_model), generator=gen,
                            device=dev) * 0.02
    res = generate(model, prompts, args.gen, audio)

    print(f"arch={cfg.name} batch={B} prompt={P} gen={args.gen} "
          f"device={dev.type}")
    print(f"prefill: {res.prefill_ms:.1f} ms   "
          f"decode: {res.decode_ms_per_token:.1f} ms/token")
    for b in range(min(B, 2)):
        print(f"  req{b}: {prompts[b, :6].tolist()}... -> "
              f"{res.tokens[b, :10].tolist()}...")
    assert bool(torch.isfinite(res.step_logits[-1]).all())

    batch = {"tokens": prompts}
    if cfg.family == "encdec":
        batch["audio_embeds"] = audio
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.zeros((B, 0, cfg.d_model), device=dev)
    with torch.no_grad():
        fused = model.prefill(batch)[:, -1].float()
    stepped = res.step_logits[P - 1].float()
    err = float((fused - stepped).abs().max() / stepped.abs().max())
    print(f"fused prefill against decode-fed logits: {err:.2e} of scale")
    assert bool(torch.isfinite(fused).all())
    if cfg.family != "moe":
        # a MoE prefill drops tokens past an expert's capacity, which
        # decode (one token, capacity 1) never does: the two differ there
        assert err < 1e-3
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
