"""Autoregressive transformer decode over the partition planner's plans.

The port of the reference's decode slice:

* :class:`TransformerSpec` + :func:`decode_graph` / :func:`prefill_graph`:
  the workload expressed in the planner IR (``ConvT.ATTN`` / ``ConvT.FFN``
  layers carrying head counts and folded score-matmul flops), so
  :func:`repro_torch.core.dpp.plan_search` prices head-sharded decode like
  any other graph (:func:`plan_decode`).
* :func:`init_transformer` / :func:`reference_decode`: a seeded pre-norm
  reference model with a contiguous, single-device KV cache — the oracle
  every sharded execution must match token for token.  The weights are the
  reference's numpy draws in the reference's order, so they are
  bit-identical to the JAX package's for the same seed;
  :func:`transformer_weights_from_numpy` carries any other set across.
* :class:`DecodeSession`: decode-step execution of a searched plan on
  ``nodes`` nodes with the distributed paged KV cache
  (:class:`repro_torch.runtime.kv_cache.PagedKVCache`).  ``Scheme.OUTC`` on
  an ATTN layer shards *heads* across nodes — each node projects, caches
  and attends only its own heads, and the one cross-node exchange is the
  head-output gather feeding the (replicated) output projection.
  ``Scheme.OUTC`` on an FFN layer column-shards ``w1`` the same way.  Any
  other scheme runs the layer replicated.

Both executors are ported.  ``ExecConfig(executor="mesh")`` runs the
step on a mesh of node streams (:func:`repro_torch.launch.mesh.
make_nodes_mesh`, the one-card mapping): each node's q/k/v products
against its column slices, its K/V writes into its own pools, its
``flash_decode_paged`` call and its ``w1`` columns run on its own stream,
and the head-output and FFN gathers concatenate the nodes' outputs into
one tensor after the join; a replicated layer runs on every node, each
writing its own pools, as the reference's mesh step does.  The paged
cache's pools are the mesh's pools, so nothing is stacked, padded or
mirrored back: no port is owed of the reference's ``_stack_pools`` and
its mirror-back of the stacked pools, which exist because ``shard_map``
takes and returns the carried pools as one ``[N, ...]`` array.
``ExecConfig(backend="cuda")`` runs each node's decode attention through
the hand-written kernel :func:`repro_torch.kernels.flash_decode_paged`
(its plain version on CPU tensors); ``backend="torch"`` runs the plain
gather-and-mask version.  The projections and the FFN are plain
``torch.matmul`` products, as the reference leaves them to XLA.

The step is one program, as the reference's jitted step is.  Its body
(:meth:`DecodeSession._step`, the same for both executors: the nodes'
parts run through a :class:`~repro_torch.launch.mesh.NodesMesh`, one
after another for the local executor, each on its stream on the mesh)
takes the token and the position as device tensors: the embedding row
is an ``index_select``, each node's K/V goes to the slot the cache
computes on the device
(:meth:`~repro_torch.runtime.kv_cache.PagedKVCache.write`), and the
decode kernel reads ``kv_len`` from device memory, so nothing in it
reads a device value on the host.  On the card ``_step_fn`` runs that body as a
:class:`~repro_torch.runtime.graphs.GraphProgram` — eager on the first
step, captured on the second, replayed on every later one; on the CPU it
is the body itself.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.graph import ConvT, LayerSpec, ModelGraph, chain
from repro_torch.core.partition import Scheme, split_sizes
from repro_torch.kernels.flash_attention import flash_decode_paged
from repro_torch.kernels.ref import flash_decode_paged_ref
from repro_torch.launch.mesh import NodesMesh, check_mesh, make_nodes_mesh
from repro_torch.runtime.graphs import GraphProgram
from repro_torch.runtime.kv_cache import PagedKVCache
from repro_torch.runtime.session import ExecConfig

__all__ = [
    "TransformerSpec", "decode_graph", "prefill_graph", "init_transformer",
    "transformer_weights_from_numpy", "reference_decode", "DecodeSession",
    "greedy_decode", "plan_decode",
]

_BLOCK_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2")


# --------------------------------------------------------------------------
# workload spec + planner IR
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TransformerSpec:
    """Decoder-only transformer shape (pre-norm, MHA, ReLU FFN)."""

    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int = 256

    def __post_init__(self) -> None:
        if self.n_layers < 1 or self.d_model < 1 or self.d_ff < 1:
            raise ValueError(f"bad transformer shape {self}")
        if self.n_heads < 1 or self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by "
                             f"n_heads {self.n_heads}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def attn_flop_factor(spec: TransformerSpec, kv_len: int) -> float:
    """True attention flops relative to the IR base (one d->d matmul).

    Per query token: four d*d projections (8d^2) plus score and value
    matmuls against ``kv_len`` cached keys (4*d*kv_len), over the 2d^2
    base the estimator charges a ``d -> d`` layer."""
    d = spec.d_model
    return 4.0 + 2.0 * float(kv_len) / d


def ffn_flop_factor(spec: TransformerSpec) -> float:
    """Two d*d_ff matmuls over the 2d^2 base."""
    return 2.0 * spec.d_ff / spec.d_model


def _graph(spec: TransformerSpec, q_len: int, kv_len: int,
           name: str) -> ModelGraph:
    layers: List[LayerSpec] = []
    af = attn_flop_factor(spec, kv_len)
    ff = ffn_flop_factor(spec)
    for i in range(spec.n_layers):
        layers.append(LayerSpec(f"b{i}.attn", ConvT.ATTN, q_len, 1,
                                spec.d_model, spec.d_model,
                                extra_flop_factor=af, heads=spec.n_heads))
        layers.append(LayerSpec(f"b{i}.ffn", ConvT.FFN, q_len, 1,
                                spec.d_model, spec.d_model,
                                extra_flop_factor=ff))
    return chain(name, layers)


def decode_graph(spec: TransformerSpec, kv_len: int) -> ModelGraph:
    """One decode step (``q_len == 1``) attending to ``kv_len`` cached
    keys — the steady-state workload the planner should optimise for."""
    return _graph(spec, 1, kv_len, f"decode_kv{kv_len}")


def prefill_graph(spec: TransformerSpec, seq_len: int) -> ModelGraph:
    """Prompt ingestion: ``seq_len`` queries attending to ``seq_len``
    keys (the factor keeps the full-matrix upper bound of the scores)."""
    return _graph(spec, seq_len, seq_len, f"prefill_s{seq_len}")


def plan_decode(spec: TransformerSpec, kv_len: int, nodes: int, tb=None,
                **kwargs):
    """Search a decode-step plan: :func:`plan_search` over
    :func:`decode_graph` with the analytic estimator."""
    from repro_torch.core.cost import Testbed
    from repro_torch.core.dpp import plan_search
    from repro_torch.core.estimator import AnalyticEstimator
    if tb is None:
        tb = Testbed(nodes=nodes, bandwidth_gbps=5.0)
    if tb.nodes != nodes:
        raise ValueError(f"testbed nodes {tb.nodes} != {nodes}")
    return plan_search(decode_graph(spec, kv_len), AnalyticEstimator(), tb,
                       **kwargs)


# --------------------------------------------------------------------------
# seeded model + single-device oracle
# --------------------------------------------------------------------------
def init_transformer(spec: TransformerSpec, seed: int = 0,
                     device="cuda") -> Dict:
    """Seeded float32 weights on ``device``: ``{"emb": [vocab, d],
    "blocks": [{wq, wk, wv, wo: [d, d], w1: [d, d_ff], w2: [d_ff, d]},
    ...]}`` — the reference's numpy draws in its order, so bit-identical
    to the JAX package's ``init_transformer`` for the same seed."""
    rng = np.random.default_rng(seed)
    d, dff = spec.d_model, spec.d_ff

    def g(rows, cols, scale):
        return torch.from_numpy(
            rng.normal(0.0, scale, (rows, cols)).astype(np.float32)).to(
                device)

    blocks = []
    for _ in range(spec.n_layers):
        blocks.append({
            "wq": g(d, d, d ** -0.5), "wk": g(d, d, d ** -0.5),
            "wv": g(d, d, d ** -0.5), "wo": g(d, d, d ** -0.5),
            "w1": g(d, dff, d ** -0.5), "w2": g(dff, d, dff ** -0.5),
        })
    return {"emb": g(spec.vocab, d, 1.0), "blocks": blocks}


def transformer_weights_from_numpy(weights_np: Dict, device="cuda") -> Dict:
    """The port's decode weights from numpy arrays in the reference
    layout ``{"emb", "blocks": [{wq, wk, wv, wo, w1, w2}, ...]}`` (e.g. the
    JAX package's ``init_transformer`` output through ``np.asarray``)."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    blocks = []
    for blk in weights_np["blocks"]:
        if set(blk) != set(_BLOCK_KEYS):
            raise ValueError(f"block keys {sorted(blk)} != "
                             f"{sorted(_BLOCK_KEYS)}")
        blocks.append({key: t(blk[key]) for key in _BLOCK_KEYS})
    return {"emb": t(weights_np["emb"]), "blocks": blocks}


def _rmsnorm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x) + 1e-6)


def _reference_step(spec: TransformerSpec, weights: Dict, x: torch.Tensor,
                    caches: List[Tuple[torch.Tensor, torch.Tensor]]):
    """One pre-norm block stack step with contiguous growing K/V."""
    H, hd = spec.n_heads, spec.head_dim
    scale = 1.0 / math.sqrt(hd)
    new = []
    for blk, (K, V) in zip(weights["blocks"], caches):
        a = _rmsnorm(x)
        q = (a @ blk["wq"]).reshape(H, hd)
        k = (a @ blk["wk"]).reshape(H, hd)
        v = (a @ blk["wv"]).reshape(H, hd)
        K = torch.cat([K, k[None]], dim=0)           # [t, H, hd]
        V = torch.cat([V, v[None]], dim=0)
        s = torch.einsum("hd,thd->ht", q, K) * scale
        p = torch.softmax(s, dim=-1)
        x = x + torch.einsum("ht,thd->hd", p, V).reshape(-1) @ blk["wo"]
        f = _rmsnorm(x)
        x = x + torch.relu(f @ blk["w1"]) @ blk["w2"]
        new.append((K, V))
    return x, new


def reference_decode(spec: TransformerSpec, weights: Dict,
                     prompt: Sequence[int], n_new: int):
    """Greedy single-device decode oracle on the weights' device →
    ``(tokens, logits)`` where ``logits`` is ``[n_new, vocab]`` (the
    distribution each emitted token was argmaxed from)."""
    emb = weights["emb"]
    z = torch.zeros((0, spec.n_heads, spec.head_dim), dtype=emb.dtype,
                    device=emb.device)
    caches = [(z, z) for _ in range(spec.n_layers)]
    x = None
    for tok in prompt:
        x, caches = _reference_step(spec, weights, emb[tok], caches)
    tokens, logits = [], []
    for _ in range(n_new):
        lg = x @ emb.T
        tok = int(torch.argmax(lg))
        tokens.append(tok)
        logits.append(lg)
        x, caches = _reference_step(spec, weights, emb[tok], caches)
    return tokens, torch.stack(logits)


# --------------------------------------------------------------------------
# sharded decode execution
# --------------------------------------------------------------------------
def _paged_attn(q, kp, vp, table, kv_len, *, scale, backend):
    """Decode attention over one node's paged pools: ``q`` [lh, hd];
    ``kp``/``vp`` [lh, P, ps, hd]; ``table`` the cache's device table."""
    if backend == "cuda":
        return flash_decode_paged(q, kp, vp, table, kv_len, scale=scale)
    return flash_decode_paged_ref(q, kp, vp, table, kv_len, scale=scale)


def _offsets(split: Sequence[int]) -> List[int]:
    out = [0]
    for s in split:
        out.append(out[-1] + s)
    return out


class DecodeSession:
    """Stateful decode of one plan on ``nodes`` nodes.

    ``plan.steps`` must pair up with :func:`decode_graph`'s layers —
    entry ``2i`` is block ``i``'s ATTN layer, ``2i+1`` its FFN.  An OutC
    ATTN step head-shards block ``i`` (KV pages live only on the owning
    nodes); an OutC FFN step column-shards ``w1``.  Everything else is
    replicated (every node keeps all heads, all pools stay full — memory
    accounting via :meth:`PagedKVCache.bytes_per_node` reflects that).

    ``config.executor`` picks the local executor (the nodes' parts one
    after another) or the mesh (each node's part on its own stream;
    ``mesh`` optionally passes a prebuilt one, else it is made over
    ``[config.device]``).  ``config.backend`` picks the attention inner:
    ``"cuda"`` the paged decode kernel, ``"torch"`` the plain
    gather-and-mask version.  ``config.device`` (default ``"cuda"``) is
    where the cache lives and the step runs; the weights must already lie
    there (see :func:`init_transformer`,
    :func:`transformer_weights_from_numpy`).  Without a card the session
    raises unless given ``device="cpu"``.  One step program serves every
    position (see the module docstring).
    """

    def __init__(self, spec: TransformerSpec, weights: Dict, plan,
                 nodes: int, config: ExecConfig = ExecConfig(), *,
                 page_size: int = 16, capacity: int = 256,
                 cache_seed: int = 0, mesh=None):
        if len(plan.steps) != 2 * spec.n_layers:
            raise ValueError(f"plan has {len(plan.steps)} steps, decode "
                             f"graph needs {2 * spec.n_layers}")
        if nodes < 1:
            raise ValueError(f"nodes must be >= 1, got {nodes}")
        self.device = torch.device(config.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass "
                "ExecConfig(device='cpu') to run on the CPU")
        if weights["emb"].device.type != self.device.type:
            raise ValueError(f"weights lie on {weights['emb'].device}, the "
                             f"session runs on {self.device}")
        self.spec = spec
        self.weights = weights
        self.plan = plan
        self.nodes = int(nodes)
        self.config = config
        H, dff = spec.n_heads, spec.d_ff
        self.attn_sharded = [plan.steps[2 * i][0] == Scheme.OUTC
                             for i in range(spec.n_layers)]
        self.ffn_sharded = [plan.steps[2 * i + 1][0] == Scheme.OUTC
                            for i in range(spec.n_layers)]
        self.head_split = [split_sizes(H, nodes) if sh else [H] * nodes
                           for sh in self.attn_sharded]
        self.ff_split = [split_sizes(dff, nodes) if sh else [dff] * nodes
                         for sh in self.ffn_sharded]
        self.cache = PagedKVCache(self.head_split, spec.head_dim,
                                  page_size, capacity, seed=cache_seed,
                                  device=self.device)
        # the step's inputs, filled in place before each step
        self._tok = torch.zeros((1,), dtype=torch.int64, device=self.device)
        self._pos = torch.zeros((), dtype=torch.int64, device=self.device)
        self._mesh = None
        # the local executor's nodes: one after another, no streams
        self._serial = NodesMesh([self.device] * self.nodes)
        body = self._local_step
        if config.executor == "mesh":
            if mesh is None:
                mesh = make_nodes_mesh(self.nodes, [self.device])
            check_mesh(mesh, self.nodes, self.device)
            self._mesh = mesh
            body = self._mesh_step
        self._step_fn = body
        if self.device.type == "cuda":
            self._step_fn = GraphProgram(body, self._tok, self._pos)

    @property
    def mesh(self):
        """The mesh of node streams (``None`` for the local executor)."""
        return self._mesh

    def step(self, token: int) -> torch.Tensor:
        """Process one token at the cache's current position; returns the
        final hidden state (feed ``h @ emb.T`` to sample the next), a
        tensor of its own that later steps leave as it is."""
        token = int(token)
        if not 0 <= token < self.spec.vocab:
            raise ValueError(f"token {token} outside the vocabulary of "
                             f"{self.spec.vocab}")
        pos = self.cache.length
        self.cache.advance(1)   # the capacity check bounds the device pos
        self._tok.fill_(token)
        self._pos.fill_(pos)
        # a replay's output lies in the graph's memory: the next step's
        # replay overwrites it
        return self._step_fn(self._tok, self._pos).clone()

    def prefill(self, prompt: Sequence[int]) -> torch.Tensor:
        """Sequential decode steps over the prompt."""
        h = None
        for tok in prompt:
            h = self.step(tok)
        return h

    def _local_step(self, tok: torch.Tensor,
                    pos: torch.Tensor) -> torch.Tensor:
        """The local executor's step body: the nodes' parts one after
        another on the calling stream; a replicated layer computed once,
        its K/V written into every node's pools."""
        return self._step(tok, pos, self._serial, every_node=False)

    def _mesh_step(self, tok: torch.Tensor,
                   pos: torch.Tensor) -> torch.Tensor:
        """The mesh's step body: each node's part on its own stream; a
        replicated layer runs on every node, each writing its own pools,
        as the reference's mesh step does."""
        return self._step(tok, pos, self._mesh, every_node=True)

    def _step(self, tok: torch.Tensor, pos: torch.Tensor, nodes: NodesMesh,
              every_node: bool) -> torch.Tensor:
        """The step body: token ``tok`` (``[1]`` int64) at position
        ``pos`` (a 0-d integer tensor), both on the session's device;
        returns the final hidden state.  Per layer, ``nodes.run`` runs
        each node's attention part (its q/k/v columns, its K/V write, its
        decode call) and then each node's ``w1`` columns; after the join
        the nodes' outputs are concatenated into one tensor (the
        head-output and FFN gathers), which the replicated norms and
        output projections read.  A replicated layer runs on every node
        (``every_node``) or on node 0 alone, which then writes every
        node's pools.  The body reads no device value on the host, so the
        card can capture it."""
        spec, cache, N = self.spec, self.cache, self.nodes
        H, hd = spec.n_heads, spec.head_dim
        scale = 1.0 / math.sqrt(hd)
        backend = self.config.backend
        table = cache.device_table
        x = self.weights["emb"].index_select(0, tok.reshape(1))[0]
        kv_len = (pos + 1).to(torch.int32).reshape(1)
        slot = cache.slot_index(pos)

        def cols(sharded: bool, split: Sequence[int], total: int):
            # node n's columns [c0, c1): its share, or all (every node,
            # or node 0 alone) when replicated
            off = _offsets(split)
            return [(off[n], off[n + 1]) if sharded
                    else (0, total) if every_node or n == 0 else (0, 0)
                    for n in range(N)]

        def gather(outs: list, sharded: bool) -> torch.Tensor:
            # a replicated layer's nodes agree: node 0's output serves
            if not sharded:
                return outs[0]
            return torch.cat([t for t in outs if t is not None])

        for i, blk in enumerate(self.weights["blocks"]):
            a = _rmsnorm(x)
            sharded = self.attn_sharded[i]
            heads = cols(sharded, self.head_split[i], H)

            def attn(n):
                h0, h1 = heads[n]
                if h1 == h0:
                    return None
                cs = slice(h0 * hd, h1 * hd)
                q = (a @ blk["wq"][:, cs]).reshape(h1 - h0, hd)
                k = (a @ blk["wk"][:, cs]).reshape(h1 - h0, hd)
                v = (a @ blk["wv"][:, cs]).reshape(h1 - h0, hd)
                for m in (range(N) if not (sharded or every_node)
                          else (n,)):
                    cache.write(i, m, slot, k, v)
                kp, vp = cache.pages(i, n)
                return _paged_attn(q, kp, vp, table, kv_len, scale=scale,
                                   backend=backend).reshape(-1)
            x = x + gather(nodes.run(attn), sharded) @ blk["wo"]
            f = _rmsnorm(x)
            ffn_cols = cols(self.ffn_sharded[i], self.ff_split[i],
                            spec.d_ff)

            def ffn(n):
                c0, c1 = ffn_cols[n]
                if c1 == c0:
                    return None
                return torch.relu(f @ blk["w1"][:, c0:c1])
            hv = gather(nodes.run(ffn), self.ffn_sharded[i])
            x = x + hv @ blk["w2"]
        return x


def greedy_decode(session: DecodeSession, prompt: Sequence[int],
                  n_new: int):
    """Greedy generation through a :class:`DecodeSession` →
    ``(tokens, logits)`` shaped exactly like :func:`reference_decode`."""
    h = session.prefill(prompt)
    emb = session.weights["emb"]
    tokens, logits = [], []
    for _ in range(n_new):
        lg = h @ emb.T
        tok = int(torch.argmax(lg))
        tokens.append(tok)
        logits.append(lg)
        h = session.step(tok)
    return tokens, torch.stack(logits)
