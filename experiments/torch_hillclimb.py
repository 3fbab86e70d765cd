"""Perf hillclimbing on the PyTorch/CUDA port: the counterpart of
``experiments/hillclimb.py``, its pairs A-D through the port's dry run
(:func:`repro_torch.launch.dryrun.run_one`, same ``strategy=`` and
``cfg_transform=`` arguments).

  A. rwkv6-3b (and zamba2-1.2b) x train_4k: the recurrent scan against
     chunk-parallel linear attention (chunk 32/64/128).
  B. granite-moe x train_4k: MoE EP against TP, the attention scheme,
     no FSDP.
  C. deepseek-v2 x train_4k: per-class scheme choice, MoE EP/TP x
     attention SP/TP.
  D. qwen2-72b decode_32k: resident TP weights against gathered ones.

Each row is one step counted on fake tensors (a full-width step costs no
memory) on the production 16 x 16 mesh, priced on the H100's roofline;
nothing runs on the card.  Like the examples, the script raises without
a card unless it is given ``--device cpu``.  Records go to
``experiments/torch_hillclimb/<pair>.json``.

Run: PYTHONPATH=src python experiments/torch_hillclimb.py [A|B|C|D|all] \\
         [--device cpu]
"""
import argparse
import dataclasses
import json
import os
import sys

from repro_torch.launch import require_device
from repro_torch.launch.dryrun import run_one
from repro_torch.runtime.shard_plan import Strategy

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_hillclimb")


def _chunk(n):
    def tf(cfg):
        return dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, chunk=n))
    return tf


EXPERIMENTS = {
    "A": [
        ("rwkv6-3b", "train_4k", "baseline recurrent scan", None, None),
        ("rwkv6-3b", "train_4k", "chunked C=32", None, _chunk(32)),
        ("rwkv6-3b", "train_4k", "chunked C=64", None, _chunk(64)),
        ("rwkv6-3b", "train_4k", "chunked C=128", None, _chunk(128)),
        ("zamba2-1.2b", "train_4k", "zamba2 baseline recurrent", None, None),
        ("zamba2-1.2b", "train_4k", "zamba2 chunked C=64", None, _chunk(64)),
    ],
    "B": [
        ("granite-moe-3b-a800m", "train_4k", "baseline planner", None, None),
        ("granite-moe-3b-a800m", "train_4k", "moe=tp attn=tp",
         Strategy(attn="tp", ffn="tp", moe="tp"), None),
        ("granite-moe-3b-a800m", "train_4k", "moe=tp attn=sp",
         Strategy(attn="sp", ffn="sp", moe="tp"), None),
        ("granite-moe-3b-a800m", "train_4k", "no-fsdp (replicated weights)",
         Strategy(attn="tp", ffn="tp", moe="tp", fsdp=False), None),
    ],
    "C": [
        ("deepseek-v2-236b", "train_4k", "baseline planner", None, None),
        ("deepseek-v2-236b", "train_4k", "moe=tp attn=sp",
         Strategy(attn="sp", ffn="tp", moe="tp"), None),
        ("deepseek-v2-236b", "train_4k", "moe=ep attn=tp",
         Strategy(attn="tp", ffn="tp", moe="ep"), None),
        ("deepseek-v2-236b", "train_4k", "moe=ep attn=sp",
         Strategy(attn="sp", ffn="sp", moe="ep"), None),
    ],
    "D": [
        ("qwen2-72b", "decode_32k", "baseline planner", None, None),
        ("qwen2-72b", "decode_32k", "ZeRO-inference (fsdp gathered)",
         Strategy(attn="tp", ffn="tp", fsdp=True,
                  decode_resident=False), None),
        ("qwen2-72b", "decode_32k", "resident TP weights",
         Strategy(attn="tp", ffn="tp", fsdp=False,
                  decode_resident=True), None),
    ],
}


def run(which: str, *, device="cuda", out_dir: str = OUT) -> dict:
    """The records of pair ``which`` (or ``"all"``), by pair: each row's
    record with its ``label``; a row that fails prints ``FAILED`` and is
    left out."""
    require_device(device)
    os.makedirs(out_dir, exist_ok=True)
    targets = EXPERIMENTS if which == "all" else {which: EXPERIMENTS[which]}
    out = {}
    for exp, rows_spec in targets.items():
        print(f"=== hillclimb {exp} ===", flush=True)
        rows = []
        for arch, shape, label, st, tf in rows_spec:
            try:
                rec = run_one(arch, shape, strategy=st, cfg_transform=tf,
                              verbose=False)
            except Exception as e:  # record failures, keep climbing
                print(f"  {label:40s} FAILED {type(e).__name__}: "
                      f"{str(e)[:160]}", flush=True)
                continue
            rec["label"] = label
            rows.append(rec)
            temp = rec["mem_per_device"]["temp_size_bytes"] or 0
            print(f"  {label:40s} comp={rec['t_compute_s']:9.4g}s "
                  f"mem={rec['t_memory_s']:9.4g}s "
                  f"coll={rec['t_collective_s']:9.4g}s "
                  f"bneck={rec['bottleneck']:10s} "
                  f"useful={rec['useful_ratio']:.3f} "
                  f"temp={temp / 1e9:.1f}GB",
                  flush=True)
        with open(os.path.join(out_dir, f"{exp}.json"), "w") as f:
            json.dump(rows, f, indent=1, default=str)
        out[exp] = rows
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("which", nargs="?", default="all",
                    choices=("A", "B", "C", "D", "all"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.which, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
