"""The LM serving path: ``repro_torch.launch.serve.generate`` on
``repro_torch.models.transformer.Model``.

Each request is one static batch: ``generate(model, prompts, gen_len)``
feeds the prompts through the decode step one position at a time and then
generates greedily, every step a replay of the decode program it captures
for the request (``runtime.steps.capture_decode_step``).  It returns every
step's logits and the generated tokens when the batch is done, with the
device synchronised.

Set-up builds the model from the registry entry the configuration names,
its widths checked against the file's (every key not listed in
``reduced`` must equal the registry's) and its block against the one the
configuration's plain reference (``reference``: a module of
``bench/reference/``) computes, makes the weights on the device from the
seed (:mod:`bench.weights`, the reference's layout) and loads them into
the model's parameters by name.  The reference reads the same tensors.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from bench import compare, counts, traffic, weights
from bench.harness import Served, reference_of
from bench.reference import precision

#: the configuration file's keys of ``ModelConfig``
CONFIG_KEYS = ("n_layers", "d_model", "n_heads", "n_kv", "d_ff", "vocab",
               "head_dim", "norm", "act", "rope_kind", "rope_theta",
               "tie_embeddings", "dtype", "attn_window", "family",
               "qkv_bias")


def model_config(config):
    """The port's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs.registry import get_config
    base = get_config(config["registry"])
    m = config["model"]
    cfg = dataclasses.replace(base, **{k: m[k] for k in CONFIG_KEYS
                                       if k in m})
    for k in CONFIG_KEYS:
        if k not in config["reduced"] and getattr(cfg, k) != getattr(base,
                                                                       k):
            raise ValueError(f"{config['name']}: {k} = {getattr(cfg, k)!r} "
                             f"differs from the registry's "
                             f"{getattr(base, k)!r} and is not in reduced")
    reference_of(config).check(dataclasses.asdict(cfg))
    return cfg


class Driver:
    def __init__(self, config, mix, check, seed, device):
        from repro_torch.models.transformer import Model
        self.config, self.mix, self.device = config, mix, device
        self.check = check
        self.cfg = model_config(config)
        self.ref = reference_of(config)
        self.widths = dict(config["model"], mlp="swiglu")
        self.vocab_ids = config["vocab_ids"]
        self.model = Model(self.cfg, device=device)
        self.weights = weights.draw(self.ref.layout(self.widths),
                                    traffic.seed_of(seed, 3),
                                    getattr(torch, self.cfg.dtype), device)
        params = dict(self.model.named_parameters())
        if set(params) != set(self.weights):
            raise ValueError(f"the model's parameters "
                             f"{sorted(set(params) ^ set(self.weights))} "
                             f"differ from the reference's layout")
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(self.weights[name])

    def warm_up(self) -> None:
        """The decode program at the cell's batch and capacity: its eager
        first call, its capture and a replay, and the argmax after."""
        from repro_torch.runtime.steps import capture_decode_step
        (p, g), b = traffic.longest(self.mix), int(self.mix["batch"])
        cache = self.model.cache_init(b, capacity=p + g)
        step = capture_decode_step(self.model, cache, b)
        tok = torch.zeros((b, 1), dtype=torch.long, device=self.device)
        for t in range(3):
            logits, cache = step(cache, tok, t)
            tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
            logits[:, -1].clone()

    def serve(self, req, tracer) -> Served:
        from repro_torch.launch import serve
        prompts = traffic.prompt_ids(req, self.vocab_ids, self.device)
        hooked = tracer is not None and req.index == tracer.request
        if hooked:
            serve.capture_decode_step = _stepping(tracer, req)
        try:
            t0 = time.perf_counter()
            res = serve.generate(self.model, prompts, req.gen_len)
            t1 = time.perf_counter()
        finally:
            if hooked:
                from repro_torch.runtime import steps
                serve.capture_decode_step = steps.capture_decode_step
                tracer.done(req)
        ok = (tuple(res.tokens.shape) == (req.batch, req.gen_len)
              and len(res.step_logits) == req.steps)
        return Served(req, t0, t1, req.batch * req.steps, [],
                      (req, prompts, res), ok)

    def keep(self, kept):
        """The ``sequences`` rows the request's seed draws: their prompts,
        generated tokens and every step's logits."""
        req, prompts, res = kept
        rows = sorted(torch.randperm(
            req.batch, generator=torch.Generator().manual_seed(req.seed))[
                :self.check["sequences"]].tolist())
        return {"prompts": prompts[rows], "tokens": res.tokens[rows],
                "logits": torch.stack([lg[rows] for lg in res.step_logits],
                                      dim=1)}

    def release(self) -> None:
        del self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def samples(self, served):
        out = []
        for s in served:
            p = s.request.prompt_len
            for r in range(len(s.kept["prompts"])):
                toks = torch.cat([s.kept["prompts"][r], s.kept["tokens"][r]])
                n = toks.shape[0]
                out.append(compare.Sample(
                    toks, torch.arange(n, device=toks.device),
                    s.kept["logits"][r],
                    torch.arange(p - 1, n - 1, device=toks.device)))
        return out

    def reference(self, tokens, positions, rounding=None):
        return self.ref.logits(self.weights, self.widths, tokens, positions,
                               precision.rounding(rounding))

    def window_flops(self, served) -> float:
        return sum(s.request.batch * counts.steps_flops(
            self.widths, 0, s.request.steps, logits=True) for s in served)

    def decode_calls(self, req, step):
        """One call a layer: every sequence's query heads over its KV
        heads at ``step + 1`` live keys."""
        w = self.widths
        es = counts.ELEMENT_BYTES[self.cfg.dtype]
        return [(req.batch * w["n_heads"], req.batch * w["n_kv"], step + 1,
                 counts.head_dim(w), es)] * w["n_layers"]


def _stepping(tracer, req):
    """``capture_decode_step`` whose program tells ``tracer`` as each step
    starts."""
    from repro_torch.runtime.steps import capture_decode_step

    def make(model, cache, batch):
        program = capture_decode_step(model, cache, batch)
        n = [0]

        def step(cache, tok, t):
            tracer.step(req, n[0])
            n[0] += 1
            return program(cache, tok, t)
        return step
    return make
