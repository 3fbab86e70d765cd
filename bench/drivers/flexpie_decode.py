"""FlexPie's planner-sharded decode: ``repro_torch.runtime.decode.
DecodeSession`` on a plan from ``plan_decode``, driven by
``greedy_decode``.

Set-up searches the plan once (``plan_decode`` over the deployment's
nodes with its default testbed, for the mix's capacity), makes the mesh
of node streams once and the weights on the device from the seed (the
decode slice's layout, :mod:`bench.reference.flexpie_block`).  Each
request is one user's prompt and generation through a new session on
that plan, mesh and weights: ``greedy_decode(session, prompt, gen_len)``,
the prompt fed through the decode step, then each token's logits, its
argmax read back on the host and fed to the next step.  A token's wall
runs from the step's call to the next step's call, which follows the
read: the host clock around ``DecodeSession.step``.
"""
from __future__ import annotations

import time

import torch

from bench import compare, counts, traffic, weights
from bench.harness import Served, reference_of
from bench.reference import precision


class Driver:
    def __init__(self, config, mix, check, seed, device):
        from repro_torch.launch.mesh import make_nodes_mesh
        from repro_torch.runtime.decode import TransformerSpec, plan_decode
        from repro_torch.runtime.session import ExecConfig
        self.config, self.mix, self.device = config, mix, device
        m = config["model"]
        self.widths = dict(m, n_kv=m["n_heads"], mlp="relu")
        self.spec = TransformerSpec(m["n_layers"], m["d_model"],
                                    m["n_heads"], m["d_ff"], m["vocab"])
        dep = config["deployment"]
        self.nodes = int(dep["nodes"])
        self.capacity = int(mix["capacity"])
        self.plan = plan_decode(self.spec, self.capacity, self.nodes).plan
        self.exec = ExecConfig(executor=dep["executor"],
                               backend=dep["backend"], device=str(device))
        self.mesh = make_nodes_mesh(self.nodes, [device])
        self.ref = reference_of(config)
        flat = weights.draw(self.ref.layout(m), traffic.seed_of(seed, 3),
                            getattr(torch, config["dtype"]), device)
        self.weights = self.ref.nest(flat, m["n_layers"])
        self.heads = self._heads_a_call()

    def session(self):
        from repro_torch.runtime.decode import DecodeSession
        return DecodeSession(self.spec, self.weights, self.plan, self.nodes,
                             self.exec, page_size=self.config["page_size"],
                             capacity=self.capacity, mesh=self.mesh)

    def _heads_a_call(self):
        """Query heads of each node's decode call, layer by layer: the
        planned split of an OutC layer, all heads on every node of the
        mesh for a replicated one."""
        from repro_torch.core.partition import Scheme, split_sizes
        H = self.spec.n_heads
        return [split_sizes(H, self.nodes)
                if self.plan.steps[2 * i][0] == Scheme.OUTC
                else [H] * self.nodes for i in range(self.spec.n_layers)]

    def warm_up(self) -> None:
        """A session at the cell's capacity: its eager first step, its
        capture and a replay, the logits and their argmax."""
        sess = self.session()
        for tok in (0, 1, 2):
            h = sess.step(tok)
            int(torch.argmax(h @ self.weights["emb"].T))

    def serve(self, req, tracer) -> Served:
        from repro_torch.runtime.decode import greedy_decode
        prompt = traffic.prompt_ids(req, self.config["vocab_ids"],
                                    self.device)[0].tolist()
        stamps = []
        t0 = time.perf_counter()
        sess = self.session()
        step = sess.step

        def timed(tok):
            stamps.append(time.perf_counter())
            if tracer is not None:
                tracer.step(req, len(stamps) - 1)
            return step(tok)
        sess.step = timed
        toks, logits = greedy_decode(sess, prompt, req.gen_len)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        if tracer is not None:
            tracer.done(req)
        p = req.prompt_len
        walls = [(stamps[i + 1] - stamps[i]) * 1e3
                 for i in range(p, req.steps - 1)]
        ok = len(toks) == req.gen_len and len(stamps) == req.steps
        return Served(req, t0, t1, req.steps, walls,
                      {"tokens": prompt + toks, "logits": logits}, ok)

    def keep(self, kept):
        return kept

    def release(self) -> None:
        del self.mesh
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def samples(self, served):
        out = []
        for s in served:
            p, g = s.request.prompt_len, s.request.gen_len
            dev = self.device
            out.append(compare.Sample(
                torch.tensor(s.kept["tokens"], device=dev),
                torch.arange(p - 1, p + g - 1, device=dev),
                s.kept["logits"], torch.arange(g, device=dev)))
        return out

    def reference(self, tokens, positions, rounding=None):
        return self.ref.logits(self.weights, self.widths, tokens, positions,
                               precision.rounding(rounding))

    def window_flops(self, served) -> float:
        """Every step's blocks and attention; logits where
        ``greedy_decode`` computes them (before each generated token)."""
        w = self.widths
        return sum(counts.steps_flops(w, 0, s.request.steps, logits=False)
                   + s.request.gen_len * counts.logits_flops(w)
                   for s in served)

    def decode_calls(self, req, step):
        hd = counts.head_dim(self.widths)
        es = counts.ELEMENT_BYTES[self.config["dtype"]]
        return [(h, h, step + 1, hd, es) for split in self.heads
                for h in split if h]
