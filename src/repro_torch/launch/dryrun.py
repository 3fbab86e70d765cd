"""Dry run: count one sharded step of every (arch x input-shape x mesh)
without running it (the port of the JAX package's ``launch/dryrun.py``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k [--multi-pod] [--attn tp|sp ...] [--out out.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The reference lowers and compiles the step with XLA on 512 fake CPU
devices and reads per-device FLOPs, bytes and collectives from the
optimized HLO.  PyTorch has no SPMD compiler, so here, on one machine and
no card:

* ``choose_strategy`` picks the :class:`Strategy` (the H100's constants);
  the sharding rules give every argument leaf its spec on the mesh, a
  shape-only :class:`~repro_torch.launch.mesh.ShapeMesh`;
* the step is built on the port's ``Model`` (``make_train_step``,
  ``make_prefill_step``, ``make_decode_step``) under ``FakeTensorMode``
  (CUDA fake tensors where the build has CUDA; CPU ones on a CPU-only
  build, whose autograd cannot hold fake CUDA tensors) and run once
  under :class:`~repro_torch.launch.op_cost.OpCounter`, with the
  activation-sharding callback installed to record each re-layout point;
* per device: FLOPs over the chips; bytes with each argument leaf at its
  shard (parameters and optimizer state after the FSDP gather, i.e. split
  by the ``model`` axis only; the cache, the batch and the tokens at their
  specs) and every intermediate at its global size over the chips (the
  SPMD ideal; XLA's replicated small ops and fusions are not modelled);
* collective bytes per device by kind, from the specs
  (:func:`collectives`), under the reference's names;
* ``mem_per_device``: ``argument_size_bytes`` the arguments' shards (exact
  given the specs), ``temp_size_bytes`` the counter's peak of live
  intermediate bytes over the chips, ``output_size_bytes`` the outputs'
  shards (train: the updated parameters and optimizer state and the
  loss; prefill: the last position's logits; decode: the logits and the
  cache).

A record keeps the reference's keys (so :mod:`repro_torch.launch.report`
is a copy); ``compile_s`` holds the seconds of the counted run.  Nothing
here sets ``XLA_FLAGS``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from typing import Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs.registry import ARCH_IDS, get_config
from ..data.pipeline import make_batch_specs
from ..models.transformer import Model
from ..optim import adamw_init
from ..runtime.planner import choose_strategy
from ..runtime.shard_ctx import (activation_sharding, batch_shard_fn,
                                 seq_shard_fn)
from ..runtime.shard_plan import (P, Strategy, batch_specs, cache_specs,
                                  data_axes, local_shape, opt_specs,
                                  param_specs, tree_leaves)
from ..runtime.steps import (make_decode_step, make_prefill_step,
                             make_train_step)
from .mesh import make_production_mesh
from .op_cost import OpCounter
from .roofline import Roofline, model_flops_estimate

# (seq_len, global_batch, mode)
SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}

LONG_WINDOW = 4_096   # sliding window used by all archs at 500k context

#: the collective kinds a record names (the reference's HLO op names)
COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter")
#: row-parallel projections: a TP spec on their input dim sums partial
#: outputs across the model axis
_ROW_PARALLEL = ("wo", "w_down", "cm_v", "w_out")
#: parameter prefixes of the blocks ``Model.loss`` checkpoints
_CHECKPOINTED = ("blocks.", "first_blocks.", "enc_blocks.")


def arch_for_shape(arch: str, shape: str):
    cfg = get_config(arch)
    if shape == "long_500k" and cfg.family in ("dense", "vlm", "moe",
                                               "encdec"):
        # sub-quadratic requirement: sliding-window attention variant
        cfg = dataclasses.replace(cfg, attn_window=LONG_WINDOW)
    return cfg


def fake_device() -> torch.device:
    """The device of the dry run's fake tensors (see the module
    docstring)."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


@dataclasses.dataclass
class StepInputs:
    """A step made ready to count: its argument trees (``args``: name ->
    tree of tensors), their specs (same structure), the step (a callable
    of no arguments) and the reference's meta fields."""
    args: Dict[str, object]
    specs: Dict[str, object]
    step: object
    meta: Dict[str, object]


def _dims(shape) -> Tuple[int, int, str]:
    return SHAPES[shape] if isinstance(shape, str) else tuple(shape)


def build_inputs(cfg, model: Model, shape, mesh, st: Strategy,
                 accum: int = 1) -> StepInputs:
    """The step of ``shape`` (a :data:`SHAPES` name or a ``(seq, batch,
    mode)`` tuple) on ``model``'s device,
    fake or real: zero batches as ``data.make_batch_specs`` shapes them
    (int32 tokens, as the reference's), AdamW state (train) or a cache of
    ``min(seq, window)`` positions read at its last position (decode)."""
    seq, batch, mode = _dims(shape)
    dev = model.device
    dp = data_axes(mesh)
    p_spec = param_specs(model, mesh, st, mode)
    params = dict(model.named_parameters())
    meta = {"mode": mode, "seq": seq, "batch": batch}

    def zeros(specs):
        return {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
                for k, v in specs.items()}
    if mode == "train":
        step = make_train_step(model, accum=accum)
        opt = adamw_init(params)
        b = zeros(make_batch_specs(cfg, seq, batch, mode="train"))
        return StepInputs(
            {"params": params, "opt": opt, "batch": b},
            {"params": p_spec, "opt": opt_specs(p_spec),
             "batch": batch_specs(b, mesh)},
            lambda: step(model, opt, b), meta)

    if mode == "prefill":
        base = make_prefill_step(model)
        b = zeros(make_batch_specs(cfg, seq, batch, mode="prefill"))
        return StepInputs({"params": params, "batch": b},
                          {"params": p_spec, "batch": batch_specs(b, mesh)},
                          lambda: base(b)[:, -1, :], meta)

    # decode: one token at the cache's last position (every key live)
    cap = min(seq, cfg.attn_window or seq)
    cache = model.cache_init(batch, cap)
    tok = zeros(make_batch_specs(cfg, seq, batch, mode="decode"))["tokens"]
    b_sharded = batch % _dpn(mesh) == 0 and batch > 1
    step = make_decode_step(model)
    meta["capacity"] = cap
    return StepInputs(
        {"params": params, "cache": cache, "tokens": tok},
        {"params": p_spec, "cache": cache_specs(cache, mesh, st),
         "tokens": P(dp, None) if b_sharded else P(None, None)},
        lambda: step(cache, tok, cap - 1), meta)


def _dpn(mesh) -> int:
    n = 1
    for a in data_axes(mesh):
        n *= mesh.shape[a]
    return n


def _model_only(spec: P, mesh) -> P:
    """``spec`` after the FSDP gather: its data axes dropped."""
    dp = set(data_axes(mesh))

    def keep(a):
        if a is None or isinstance(a, str):
            return None if a in dp else a
        rest = tuple(x for x in a if x not in dp)
        return rest or None
    return P(*(keep(a) for a in spec))


def _pairs(inputs: StepInputs):
    """(tree name, tensor, spec) of every argument leaf."""
    for name, tree in inputs.args.items():
        yield from ((name, t, spec) for t, spec in zip(
            tree_leaves(tree), tree_leaves(inputs.specs[name]), strict=True))


def argument_bytes(inputs: StepInputs, mesh) -> int:
    """The arguments' shards on one card, each storage once (the cache's
    layers share one page table)."""
    seen, total = set(), 0
    for _, t, spec in _pairs(inputs):
        key = t.untyped_storage()._cdata
        if key in seen:
            continue
        seen.add(key)
        total += math.prod(local_shape(t.shape, spec, mesh)) \
            * t.element_size()
    return total


def count_step(cfg, model: Model, shape, mesh, st: Strategy, *,
               accum: int = 1):
    """Build ``shape``'s step on ``model`` (fake or real tensors) and run
    it once under an :class:`OpCounter` over ``mesh``, its arguments
    registered at their per-card shares and the activation-sharding
    callback recording re-layouts.  Returns ``(counter, inputs, seconds,
    sp)``, ``sp`` whether activations were sequence-sharded."""
    inputs = build_inputs(cfg, model, shape, mesh, st, accum)
    counter = OpCounter(chips=mesh.size)
    for name, t, spec in _pairs(inputs):
        traffic = _model_only(spec, mesh) if name in ("params", "opt") \
            else spec
        local = math.prod(local_shape(t.shape, traffic, mesh))
        counter.argument(t, t.numel() / max(1, local))
    mode = inputs.meta["mode"]
    # activation constraint = the planner's scheme choice made concrete.
    # SSM/hybrid time-scans cannot shard the sequence axis (recurrence);
    # decode steps have S=1 — both fall back to batch-only sharding.
    sp = (mode != "decode" and cfg.family not in ("ssm", "hybrid")
          and (st.attn == "sp" or st.ffn == "sp"))
    dp = data_axes(mesh)
    act_fn = (seq_shard_fn(mesh, dp, record=counter.relayout) if sp
              else batch_shard_fn(mesh, dp, record=counter.relayout))
    t0 = time.perf_counter()
    with activation_sharding(act_fn), counter:
        inputs.step()
    return counter, inputs, time.perf_counter() - t0, sp


def collectives(cfg, inputs: StepInputs, mesh, st: Strategy, sp: bool,
                relayouts=()) -> Dict[str, float]:
    """Collective bytes per card of one step, by kind, from the specs (the
    result bytes of each collective, as the reference reads them from
    HLO).  A pass is one forward (inference), or in training the forward,
    the remat recompute (checkpointed blocks only) and the backward.

    * ``all-gather``: each FSDP leaf (a spec with a data axis) gathered to
      its model-axis shard at every pass, times its applications a pass
      (Zamba2's shared block runs once per Mamba2 run); with sequence-
      sharded attention (``sp``), K and V gathered for the whole sequence
      at each attention application in the forward passes, and the
      activations gathered at each block whose attention and MLP schemes
      differ; and each re-layout point whose target spec differs from the
      previous point's.
    * ``reduce-scatter``: in training, each FSDP leaf's gradient to its
      shard; with ``sp``, dK and dV in the backward.
    * ``all-reduce``: each row-parallel output (``wo``, ``w_down``,
      ``cm_v``, ``w_out`` with ``model`` on the input dim) at every pass
      (the backward's is the input gradient of the column-parallel
      projections); in training, the gradient of each leaf replicated
      over the data axes.

    An axis of one card moves nothing.  MoE's expert dispatch (an
    all-to-all on a real mesh) is not priced."""
    mode, seq, batch = (inputs.meta[k] for k in ("mode", "seq", "batch"))
    dpn = _dpn(mesh)
    m = mesh.shape["model"]
    dp = set(data_axes(mesh))
    b_local = batch // dpn if batch % dpn == 0 and batch > 1 else batch
    tokens = b_local * (seq if mode != "decode" else 1)
    act = getattr(torch, cfg.dtype).itemsize
    every = cfg.hybrid_attn_every or cfg.n_layers
    n_shared = -(-cfg.n_layers // every) if cfg.family == "hybrid" else 1
    out = {k: 0.0 for k in COLL_KINDS}

    def axes(spec):
        names = set()
        for a in spec:
            if isinstance(a, str):
                names.add(a)
            elif a is not None:
                names.update(a)
        return names

    def passes(name: str) -> int:
        if mode != "train":
            return 1
        return 3 if name.startswith(_CHECKPOINTED) else 2

    for name, t in inputs.args["params"].items():
        spec = inputs.specs["params"][name]
        apps = n_shared if name.startswith("shared_attn.") else 1
        gathered = math.prod(local_shape(t.shape, _model_only(spec, mesh),
                                         mesh)) * t.element_size()
        shard = math.prod(local_shape(t.shape, spec, mesh)) \
            * t.element_size()
        fsdp = bool(axes(spec) & dp)
        if fsdp and dpn > 1:
            out["all-gather"] += gathered * passes(name) * apps
            if mode == "train":
                out["reduce-scatter"] += shard
        elif mode == "train" and dpn > 1:
            out["all-reduce"] += shard
        leaf = name.split(".")[-1]
        if leaf in _ROW_PARALLEL and t.dim() == 2 and spec and m > 1 \
                and "model" in axes((spec[0],)):
            out["all-reduce"] += tokens * t.shape[1] * act \
                * passes(name) * apps
    if sp and m > 1 and cfg.family in ("dense", "vlm", "moe", "encdec"):
        n_self = cfg.n_layers + cfg.n_enc_layers
        if cfg.mla:
            kv = cfg.n_heads * (cfg.mla.qk_nope + cfg.mla.qk_rope
                                + cfg.mla.v_head) // 2
        else:
            kv = cfg.n_kv * cfg.hd
        kv_bytes = 2.0 * b_local * seq * kv * act * n_self
        fwd = 2 if mode == "train" else 1
        if st.attn == "sp":
            out["all-gather"] += kv_bytes * fwd
            if mode == "train":
                out["reduce-scatter"] += kv_bytes
        if st.attn != st.ffn:
            out["all-gather"] += b_local * seq * cfg.d_model * act \
                * n_self * (3 if mode == "train" else 1)
    prev = None
    for shape, spec in relayouts:
        if prev is not None and spec != prev:
            out["all-gather"] += math.prod(local_shape(shape, spec, mesh)) \
                * act
        prev = spec
    return {k: v for k, v in out.items() if v}


def run_one(arch: str, shape: str, *, multi_pod: bool = False,
            strategy: Optional[Strategy] = None,
            cfg_transform=None, accum: int = 1, mesh=None,
            verbose: bool = True) -> dict:
    """One dry-run record of ``arch`` at ``shape`` (a :data:`SHAPES` name
    or a ``(seq, batch, mode)`` tuple) on the production mesh, or on
    ``mesh``."""
    cfg = arch_for_shape(arch, shape)
    if cfg_transform is not None:
        cfg = cfg_transform(cfg)
    seq, batch, mode = _dims(shape)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    st = strategy or choose_strategy(cfg, mesh, mode)
    with FakeTensorMode():
        model = Model(cfg, device=fake_device())
        counter, inputs, secs, sp = count_step(cfg, model, shape, mesh, st,
                                               accum=accum)
        args_b = argument_bytes(inputs, mesh)
        out_b = _output_bytes(cfg, inputs, mesh)
    mesh_name = "x".join(str(v) for v in mesh.shape.values())
    coll = collectives(cfg, inputs, mesh, st, sp, counter.relayouts)
    roof = Roofline(arch=arch, shape=shape, mesh=mesh_name, chips=mesh.size,
                    hlo_flops=counter.flops, hlo_bytes=counter.bytes,
                    coll_bytes=coll,
                    model_flops=model_flops_estimate(cfg, seq, batch, mode))
    rec = roof.row()
    temp = counter.peak_bytes / mesh.size
    rec.update({
        "strategy": dataclasses.asdict(st),
        "compile_s": round(secs, 1),
        "mem_per_device": {
            "argument_size_bytes": args_b,
            "output_size_bytes": out_b,
            "temp_size_bytes": temp,
            "peak_bytes": args_b + temp,
        },
        "kernel_units": dict(counter.units),
        **inputs.meta,
    })
    if verbose:
        print(json.dumps(rec, indent=1, default=str))
    return rec


def _output_bytes(cfg, inputs: StepInputs, mesh) -> int:
    mode, batch = inputs.meta["mode"], inputs.meta["batch"]
    act = getattr(torch, cfg.dtype).itemsize
    m = mesh.shape["model"]
    dpn = _dpn(mesh)
    rows = batch // dpn if batch % dpn == 0 and batch > 1 else batch
    vocab = cfg.vocab // m if cfg.vocab % m == 0 else cfg.vocab
    if mode == "train":
        keep = {k: v for k, v in inputs.args.items() if k != "batch"}
        part = StepInputs(keep, {k: inputs.specs[k] for k in keep}, None,
                          inputs.meta)
        return argument_bytes(part, mesh) + 4
    logits = rows * vocab * act
    if mode == "prefill":
        return logits
    part = StepInputs({"cache": inputs.args["cache"]},
                      {"cache": inputs.specs["cache"]}, None, inputs.meta)
    return logits + argument_bytes(part, mesh)


def main(argv=None) -> list:
    """The CLI; returns the records it made.  With ``--all``, a
    combination the counter cannot count (ROADMAP A 7.4) is printed as
    not counted and the rest go on; alone, it raises."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    # explicit FCO decision variables (default: the planner decides)
    ap.add_argument("--attn", choices=("tp", "sp"))
    ap.add_argument("--ffn", choices=("tp", "sp"))
    ap.add_argument("--moe", choices=("ep", "tp"))
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--resident", action="store_true",
                    help="decode: TP-resident weights (no data-axis shard)")
    ap.add_argument("--ssm-chunk", type=int, default=0,
                    help="chunk-parallel SSM scan width (0 = recurrent)")
    args = ap.parse_args(argv)

    strategy = None
    if args.attn or args.ffn or args.moe or args.no_fsdp or args.resident:
        strategy = Strategy(attn=args.attn or "sp", ffn=args.ffn or "tp",
                            moe=args.moe or "ep", fsdp=not args.no_fsdp,
                            decode_resident=args.resident)
    cfg_transform = None
    if args.ssm_chunk:
        def cfg_transform(cfg, _n=args.ssm_chunk):
            if cfg.ssm is None:
                return cfg
            return dataclasses.replace(
                cfg, ssm=dataclasses.replace(cfg.ssm, chunk=_n))

    records = []
    if args.all:
        combos = [(a, s, mp) for a in ARCH_IDS for s in SHAPES
                  for mp in (False, True)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        combos = [(args.arch, args.shape, args.multi_pod)]
    for arch, shape, mp in combos:
        print(f"== dryrun {arch} {shape} mesh={'2x16x16' if mp else '16x16'}",
              flush=True)
        try:
            records.append(run_one(arch, shape, multi_pod=mp,
                                   strategy=strategy,
                                   cfg_transform=cfg_transform))
        except NotImplementedError as e:
            if not args.all:
                raise
            print(f"== not counted: {e}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1, default=str)
    return records


if __name__ == "__main__":
    argv = sys.argv[1:]
    n = len(ARCH_IDS) * len(SHAPES) * 2 if "--all" in argv else 1
    sys.exit(0 if len(main(argv)) == n else 1)
