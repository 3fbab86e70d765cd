"""Model assembly for all registry architectures: the port of the JAX
package's ``models/transformer.py``.

:class:`Model` is one ``nn.Module`` a config, its blocks ``nn.Module``\\ s
whose parameters carry the reference pytree's names and layouts
(``[d_in, d_out]`` projections, ``x @ w``), so that
:func:`params_from_numpy` carries the reference's ``Model.init`` pytree
across leaf for leaf, a copy and never a transpose.  Entry points:

  * ``forward(batch) -> (logits, aux)``, ``loss(batch)``, ``prefill``
  * ``encode`` / ``encode_cross`` (Whisper)
  * ``cache_init(batch, capacity)``, ``decode_step(cache, tok, t)``

``forward``, ``encode`` and ``loss`` are differentiable (training); with
``remat`` each block runs under ``torch.utils.checkpoint`` (non-reentrant),
as the reference wraps each scanned block in ``jax.checkpoint``: its
activations are recomputed in the backward.  ``prefill``, ``encode_cross``
and ``decode_step`` run under ``no_grad``.  :func:`params_to_numpy` is the
inverse of :func:`params_from_numpy`.

The reference scans stacked layer parameters (``lax.scan``); here the
layers are a ``ModuleList`` walked in a Python loop.  Its ``constrain``
calls (the sharding context's re-layout points,
:mod:`repro_torch.runtime.shard_ctx`) stand where its ``_scan_blocks``
has them: at each block's entry and after each stack of blocks; they are
the identity unless the dry run installs a callback, and stand outside
a block's checkpoint, so the recompute does not call them again.  Decode
updates the cache in place, every entry in its own tensors, and takes
its position as an int or a 0-d device tensor, so a captured step
(``runtime.steps.capture_decode_step``) replays at every position.  Every family is here: dense, vlm, moe (with
``first_dense`` and MLA), ssm (RWKV-6), hybrid (Zamba2: one shared
attention block after every ``hybrid_attn_every`` Mamba2 blocks) and
encdec (Whisper).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..runtime.shard_ctx import constrain
from . import attention as A
from . import ffn as F
from . import ssm as S
from .common import (Norm, _param, apply_norm, cross_entropy, dense_init,
                     dtype_of, embed_init, normal, sinusoidal_pos,
                     sinusoidal_pos_at)

#: pytree keys whose leaves carry a leading layer axis (``_stack_init``)
STACKED = ("blocks", "first_blocks", "enc_blocks")


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

class DenseBlock(torch.nn.Module):
    """Pre-norm attention (GQA or MLA) and MLP; also the encoder's block
    and Zamba2's shared attention block."""

    def __init__(self, cfg, device, dtype):
        super().__init__()
        self.ln1 = Norm(cfg, cfg.d_model, device, dtype)
        self.attn = (A.MLA if cfg.mla else A.Attention)(cfg, device, dtype)
        self.ln2 = Norm(cfg, cfg.d_model, device, dtype)
        self.mlp = F.MLP(cfg, device, dtype)


class MoEBlock(torch.nn.Module):
    def __init__(self, cfg, device, dtype):
        super().__init__()
        self.ln1 = Norm(cfg, cfg.d_model, device, dtype)
        self.attn = (A.MLA if cfg.mla else A.Attention)(cfg, device, dtype)
        self.ln2 = Norm(cfg, cfg.d_model, device, dtype)
        self.moe = F.MoE(cfg, device, dtype)


class MambaBlock(torch.nn.Module):
    def __init__(self, cfg, device, dtype):
        super().__init__()
        self.ln = Norm(cfg, cfg.d_model, device, dtype)
        self.mamba = S.Mamba2(cfg, device, dtype)


class RWKVBlock(torch.nn.Module):
    def __init__(self, cfg, device, dtype):
        super().__init__()
        self.ln1 = Norm(cfg, cfg.d_model, device, dtype)
        self.ln2 = Norm(cfg, cfg.d_model, device, dtype)
        self.tmix = S.RWKV6(cfg, device, dtype)


class DecBlock(torch.nn.Module):
    """Whisper's decoder block: self-attention, cross-attention, MLP."""

    def __init__(self, cfg, device, dtype):
        super().__init__()
        self.ln1 = Norm(cfg, cfg.d_model, device, dtype)
        self.attn = A.Attention(cfg, device, dtype)
        self.ln_x = Norm(cfg, cfg.d_model, device, dtype)
        self.xattn = A.Attention(cfg, device, dtype)
        self.ln2 = Norm(cfg, cfg.d_model, device, dtype)
        self.mlp = F.MLP(cfg, device, dtype)


def _attn_full(cfg, p, h, pos, pos3, window):
    if cfg.mla:
        return A.mla_full(cfg, p, h, pos=pos, window=window)
    return A.gqa_full(cfg, p, h, causal=True, pos=pos, pos3=pos3,
                      window=window)


def _dense_block(cfg, p: DenseBlock, x, pos, pos3, window):
    h = apply_norm(cfg, x, p.ln1)
    x = x + _attn_full(cfg, p.attn, h, pos, pos3, window)
    return x + F.mlp(cfg, p.mlp, apply_norm(cfg, x, p.ln2))


def _moe_block(cfg, p: MoEBlock, x, pos, pos3, window):
    h = apply_norm(cfg, x, p.ln1)
    x = x + _attn_full(cfg, p.attn, h, pos, pos3, window)
    out, aux = F.moe(cfg, p.moe, apply_norm(cfg, x, p.ln2))
    return x + out, aux


def _mamba_block(cfg, p: MambaBlock, x):
    return x + S.mamba2_full(cfg, p.mamba, apply_norm(cfg, x, p.ln))


def _rwkv_block(cfg, p: RWKVBlock, x):
    x = x + S.rwkv6_time_mix(cfg, p.tmix, apply_norm(cfg, x, p.ln1))
    return x + S.rwkv6_channel_mix(cfg, p.tmix, apply_norm(cfg, x, p.ln2))


def _block(remat: bool, fn, *args):
    """``fn(*args)``, under non-reentrant activation checkpointing when
    ``remat`` and autograd records (the reference's ``jax.checkpoint``
    around a scanned block).  The blocks draw no random numbers, so the
    RNG state is not saved."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _dense_cfg(cfg):
    """DeepSeek's leading dense layers: the config with their d_ff."""
    return dataclasses.replace(cfg, d_ff=cfg.moe.d_ff_dense or cfg.d_ff)


# ---------------------------------------------------------------------------
# Model facade
# ---------------------------------------------------------------------------

#: constant initial values by parameter name (norm scales, biases, SSM
#: decays and skips); every other parameter is drawn from a normal
_CONST = {"w": 1.0, "ln_w": 1.0, "d_skip": 1.0, "dt_bias": -2.0,
          "decay_bias": -4.0, "u_bonus": 0.0}


class Model(torch.nn.Module):
    """One registry architecture on ``device`` (``"cuda"`` unless the
    caller asks for ``"cpu"``), in ``cfg.dtype``.  The parameters are
    allocated uninitialised: fill them with :meth:`init` or carry them
    with :func:`params_from_numpy`."""

    def __init__(self, cfg, device="cuda"):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Model on device 'cuda' needs a CUDA device; "
                               "pass device='cpu' to run on the CPU")
        self.cfg = cfg
        dt = dtype_of(cfg)
        d = cfg.d_model
        self.tok_emb = _param((cfg.vocab, d), device, dt)
        self.final_norm = Norm(cfg, d, device, dt)
        if not cfg.tie_embeddings:
            self.lm_head = _param((d, cfg.vocab), device, dt)

        def stack(block, c, n):
            return torch.nn.ModuleList(block(c, device, dt)
                                       for _ in range(n))

        fam = cfg.family
        if fam in ("dense", "vlm"):
            self.blocks = stack(DenseBlock, cfg, cfg.n_layers)
        elif fam == "moe":
            m = cfg.moe
            if m.first_dense:
                self.first_blocks = stack(DenseBlock, _dense_cfg(cfg),
                                          m.first_dense)
            self.blocks = stack(MoEBlock, cfg, cfg.n_layers - m.first_dense)
        elif fam == "ssm":
            self.blocks = stack(RWKVBlock, cfg, cfg.n_layers)
        elif fam == "hybrid":
            self.blocks = stack(MambaBlock, cfg, cfg.n_layers)
            self.shared_attn = DenseBlock(cfg, device, dt)
        elif fam == "encdec":
            self.enc_blocks = stack(DenseBlock, cfg, cfg.n_enc_layers)
            self.blocks = stack(DecBlock, cfg, cfg.n_layers)
            self.enc_norm = Norm(cfg, d, device, dt)
        else:
            raise ValueError(fam)

    @property
    def device(self) -> torch.device:
        return self.tok_emb.device

    # ---------------- init ----------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Random weights with the reference's distributions (its bits come
        from ``jax.random`` and cannot be reproduced here): embeddings
        N(0, 0.02^2), projections N(0, 1/fan_in) with the fan-in axis the
        reference's (``[E, d_in, d_out]`` experts, MLA's ``w_uk`` its last
        axis), Mamba2's conv N(0, 0.1^2), norm scales and skips 1, biases 0,
        the SSM decay constants of the reference.  Draws on the
        generator's device, which should be the model's."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in _CONST or p.dim() == 1:
                p.fill_(_CONST.get(leaf, 0.0))
                continue
            if leaf == "tok_emb":
                p.copy_(embed_init(generator, *p.shape, p.dtype))
            elif leaf == "conv_w":
                p.copy_(normal(generator, p.shape, 0.1, p.dtype))
            elif leaf == "w_uk":        # [H, qk_nope, kv_lora]
                p.copy_(normal(generator, p.shape, p.shape[2] ** -0.5,
                               p.dtype))
            elif p.dim() == 2:
                p.copy_(dense_init(generator, *p.shape, p.dtype))
            else:                       # [E, d_in, d_out], MLA's w_uv
                p.copy_(normal(generator, p.shape, p.shape[1] ** -0.5,
                               p.dtype))
        return self

    # ---------------- shared pieces ----------------
    def _logits(self, x):
        x = apply_norm(self.cfg, x, self.final_norm)
        if self.cfg.tie_embeddings:
            return x @ self.tok_emb.T
        return x @ self.lm_head

    def _positions(self, batch) -> Tuple[Optional[torch.Tensor],
                                         Optional[torch.Tensor]]:
        """(pos [B,S], pos3 [B,3,S]) for the decoder stream."""
        cfg, dev = self.cfg, self.device
        B, Stx = batch["tokens"].shape
        if cfg.family == "vlm":
            nv = cfg.vision_tokens
            side = max(1, int(math.sqrt(nv)))
            iv = torch.arange(nv, dtype=torch.int32, device=dev)
            t_t = torch.arange(Stx, dtype=torch.int32, device=dev) + 1
            pos3 = torch.stack([torch.cat([torch.zeros_like(iv), t_t]),
                                torch.cat([iv // side, t_t]),
                                torch.cat([iv % side, t_t])])
            return None, pos3[None].expand(B, 3, nv + Stx)
        pos = torch.arange(Stx, dtype=torch.int32, device=dev)
        return pos[None].expand(B, Stx), None

    # ---------------- full forward ----------------
    def forward(self, batch: Dict[str, torch.Tensor], *,
                remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (logits over the decoder stream, aux loss).  ``remat``
        checkpoints each block (:func:`_block`)."""
        cfg = self.cfg
        window = cfg.attn_window
        x = self.tok_emb[batch["tokens"]]
        aux = torch.zeros((), device=x.device)
        if cfg.family == "vlm":
            x = torch.cat([batch["vision_embeds"].to(x.dtype), x], dim=1)
        pos, pos3 = self._positions(batch)

        def dense(c, p):
            return lambda h: _dense_block(c, p, h, pos, pos3, window)

        fam = cfg.family
        if fam in ("dense", "vlm"):
            for p in self.blocks:
                x = _block(remat, dense(cfg, p), constrain(x))
            x = constrain(x)
        elif fam == "moe":
            if cfg.moe.first_dense:
                for p in self.first_blocks:
                    x = _block(remat, dense(_dense_cfg(cfg), p),
                               constrain(x))
                x = constrain(x)
            auxs = []
            for p in self.blocks:
                x, a = _block(remat, lambda h, p=p: _moe_block(
                    cfg, p, h, pos, pos3, window), constrain(x))
                auxs.append(a)
            x = constrain(x)
            aux = aux + torch.stack(auxs).sum()
        elif fam == "ssm":
            for p in self.blocks:
                x = _block(remat, lambda h, p=p: _rwkv_block(cfg, p, h),
                           constrain(x))
            x = constrain(x)
        elif fam == "hybrid":
            x = self._hybrid_forward(x, pos, window, remat)
        elif fam == "encdec":
            x = self._encdec_forward(batch, x, window, remat)
        else:
            raise ValueError(fam)

        logits = self._logits(x)
        if fam == "vlm":
            logits = logits[:, cfg.vision_tokens:, :]
        return logits, aux

    def _hybrid_forward(self, x, pos, window, remat):
        """Zamba2: the shared attention block after every
        ``hybrid_attn_every`` Mamba2 blocks and after the last (outside
        the checkpoint, as in the reference): each run of Mamba2 blocks
        before it is one stack."""
        cfg = self.cfg
        every = cfg.hybrid_attn_every or cfg.n_layers
        for i, p in enumerate(self.blocks):
            x = _block(remat, lambda h, p=p: _mamba_block(cfg, p, h),
                       constrain(x))
            if (i + 1) % every == 0 or i == cfg.n_layers - 1:
                x = _dense_block(cfg, self.shared_attn, constrain(x), pos,
                                 None, window)
        return x

    def encode(self, audio_embeds: torch.Tensor, *,
               remat: bool = False) -> torch.Tensor:
        """Whisper encoder over stub frame embeddings -> [B, enc_seq, d]."""
        cfg = self.cfg
        enc = audio_embeds.to(dtype_of(cfg))
        enc = enc + sinusoidal_pos(enc.shape[1], cfg.d_model,
                                   enc.device).to(enc.dtype)

        def ebody(p, h):
            h = h + A.gqa_full(cfg, p.attn, apply_norm(cfg, h, p.ln1),
                               causal=False)
            return h + F.mlp(cfg, p.mlp, apply_norm(cfg, h, p.ln2))
        for p in self.enc_blocks:
            enc = _block(remat, lambda h, p=p: ebody(p, h), constrain(enc))
        return apply_norm(cfg, constrain(enc), self.enc_norm)

    def _encdec_forward(self, batch, x, window, remat):
        cfg = self.cfg
        enc = self.encode(batch["audio_embeds"], remat=remat)
        x = x + sinusoidal_pos(x.shape[1], cfg.d_model,
                               x.device).to(x.dtype)

        def dbody(p, h):
            h = h + A.gqa_full(cfg, p.attn, apply_norm(cfg, h, p.ln1),
                               causal=True, window=window)
            h = h + A.gqa_full(cfg, p.xattn, apply_norm(cfg, h, p.ln_x),
                               causal=False, kv_x=enc)
            return h + F.mlp(cfg, p.mlp, apply_norm(cfg, h, p.ln2))
        for p in self.blocks:
            x = _block(remat, lambda h, p=p: dbody(p, h), constrain(x))
        return constrain(x)

    # ---------------- loss ----------------
    def loss(self, batch, *, remat: bool = True) -> torch.Tensor:
        logits, aux = self.forward(batch, remat=remat)
        return cross_entropy(logits, batch["labels"]) + aux

    # prefill = forward returning logits (serving feeds the prompt through
    # decode_step, as the reference's launcher does); no autograd graph,
    # whether or not the weights require gradients
    @torch.no_grad()
    def prefill(self, batch) -> torch.Tensor:
        return self.forward(batch)[0]

    # ---------------- decode ----------------
    def cache_init(self, batch: int, capacity: int) -> Dict[str, Any]:
        """Per-layer cache pages (a list a layer kind) on the model's
        device; the GQA caches share one identity page table, the decode
        kernel's view of each ``[B, KV, capacity, hd]`` cache."""
        cfg, dev = self.cfg, self.device
        dt = dtype_of(cfg)
        fam = cfg.family
        table = A.page_table(capacity, dev)

        def gqa():
            return A.gqa_cache_init(cfg, batch, capacity, dt, dev, table)

        if fam in ("dense", "vlm", "moe"):
            mk = (lambda: A.mla_cache_init(cfg, batch, capacity, dt, dev)) \
                if cfg.mla else gqa
            n_first = cfg.moe.first_dense if cfg.moe else 0
            out = {"layers": [mk() for _ in range(cfg.n_layers - n_first)]}
            if n_first:
                out["first_layers"] = [mk() for _ in range(n_first)]
            return out
        if fam == "ssm":
            return {"layers": [S.rwkv6_state_init(cfg, batch, dev)
                               for _ in range(cfg.n_layers)]}
        if fam == "hybrid":
            n_attn = -(-cfg.n_layers // (cfg.hybrid_attn_every
                                         or cfg.n_layers))
            return {"layers": [S.mamba2_state_init(cfg, batch, dt, dev)
                               for _ in range(cfg.n_layers)],
                    "attn_layers": [gqa() for _ in range(n_attn)]}
        if fam == "encdec":
            xshape = (batch, cfg.n_kv, cfg.enc_seq, cfg.hd)
            return {"layers": [gqa() for _ in range(cfg.n_layers)],
                    # cross-attn K/V cached once at prefill
                    "xlayers": [{"xk": torch.zeros(xshape, dtype=dt,
                                                   device=dev),
                                 "xv": torch.zeros(xshape, dtype=dt,
                                                   device=dev)}
                                for _ in range(cfg.n_layers)]}
        raise ValueError(fam)

    @torch.no_grad()
    def encode_cross(self, audio_embeds: torch.Tensor):
        """Whisper serve-time prefill: encoder forward + per-layer cross
        K/V cache pages (fills ``cache['xlayers']``)."""
        enc = self.encode(audio_embeds)
        return [dict(zip(("xk", "xv"), A.cross_kv(self.cfg, p.xattn, enc)))
                for p in self.blocks]

    def capacity(self, cache) -> Optional[int]:
        """The keys ``cache`` holds a layer (None for RWKV's states)."""
        for key in ("layers", "attn_layers", "first_layers"):
            for c in cache.get(key, ()):
                if "k" in c:
                    return c["k"].shape[2]
                if "c_kv" in c:
                    return c["c_kv"].shape[1]
        return None

    def check_position(self, cache, t: int) -> None:
        """``ValueError`` unless host position ``t`` has a slot in
        ``cache`` (RWKV's states have none to miss): with no window,
        ``0 .. capacity - 1`` (the reference's
        ``dynamic_update_slice`` clamps the write into the last slot, a
        divergence kept on purpose).  :meth:`decode_step` runs it before
        any write; a captured step reads its position from device memory,
        so its caller runs it before each replay."""
        cap = self.capacity(cache)
        if cap is not None and (t < 0 or (self.cfg.attn_window is None
                                          and t >= cap)):
            raise ValueError(f"decode position {t} outside a cache of "
                             f"{cap} keys with no window")

    @torch.no_grad()
    def decode_step(self, cache, tok: torch.Tensor,
                    t) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """tok [B,1] int; ``t`` the position, a Python int or a 0-d integer
        tensor on the model's device (the reference's traced ``jnp.int32``:
        nothing then reads it on the host, so one captured step serves
        every position, :func:`repro_torch.runtime.steps.
        capture_decode_step`).  Returns (logits [B,1,V], the cache, updated
        in place: every family's entries keep their tensors)."""
        cfg = self.cfg
        if not isinstance(t, torch.Tensor):
            self.check_position(cache, t)
        x = self.tok_emb[tok]
        fam = cfg.family
        if fam in ("dense", "vlm", "moe"):
            # decode MoE is drop-free: groups = batch rows with one token
            # each, so per-(group, expert) capacity 1 suffices exactly
            rope_pos = t + 1 if fam == "vlm" else t
            attn = A.mla_decode if cfg.mla else A.gqa_decode

            def body(c, h, p, c_):
                hh = apply_norm(c, h, p.ln1)
                a, _ = attn(c, p.attn, hh, c_, t, rope_pos=rope_pos)
                h = h + a
                hh = apply_norm(c, h, p.ln2)
                if isinstance(p, MoEBlock):
                    return h + F.moe(c, p.moe, hh, capacity=1)[0]
                return h + F.mlp(c, p.mlp, hh)

            if fam == "moe" and cfg.moe.first_dense:
                for p, c_ in zip(self.first_blocks, cache["first_layers"]):
                    x = body(_dense_cfg(cfg), x, p, c_)
            for p, c_ in zip(self.blocks, cache["layers"]):
                x = body(cfg, x, p, c_)
        elif fam == "ssm":
            for p, c_ in zip(self.blocks, cache["layers"]):
                a, _ = S.rwkv6_decode(cfg, p.tmix, apply_norm(cfg, x, p.ln1),
                                      c_)
                x = x + a
                x = x + S.rwkv6_channel_mix(cfg, p.tmix,
                                            apply_norm(cfg, x, p.ln2))
        elif fam == "hybrid":
            x = self._hybrid_decode(cache, x, t)
        elif fam == "encdec":
            x = self._encdec_decode(cache, x, t)
        else:
            raise ValueError(fam)
        return self._logits(x), cache

    def _hybrid_decode(self, cache, x, t):
        cfg = self.cfg
        every = cfg.hybrid_attn_every or cfg.n_layers
        pa, ai = self.shared_attn, 0
        for i, (p, c_) in enumerate(zip(self.blocks, cache["layers"])):
            a, _ = S.mamba2_decode(cfg, p.mamba, apply_norm(cfg, x, p.ln), c_)
            x = x + a
            if (i + 1) % every == 0 or i == cfg.n_layers - 1:
                a, _ = A.gqa_decode(cfg, pa.attn, apply_norm(cfg, x, pa.ln1),
                                    cache["attn_layers"][ai], t)
                x = x + a
                x = x + F.mlp(cfg, pa.mlp, apply_norm(cfg, x, pa.ln2))
                ai += 1
        return x

    def _encdec_decode(self, cache, x, t):
        cfg = self.cfg
        x = x + sinusoidal_pos_at(t, cfg.d_model, x.device).to(x.dtype)
        for p, c_, xc in zip(self.blocks, cache["layers"], cache["xlayers"]):
            a, _ = A.gqa_decode(cfg, p.attn, apply_norm(cfg, x, p.ln1), c_, t)
            x = x + a
            x = x + A.gqa_cross_cached(cfg, p.xattn,
                                       apply_norm(cfg, x, p.ln_x), xc["xk"],
                                       xc["xv"])
            x = x + F.mlp(cfg, p.mlp, apply_norm(cfg, x, p.ln2))
        return x


# ---------------------------------------------------------------------------
# Carrying the reference's weights
# ---------------------------------------------------------------------------

def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    """``tree``'s leaves under dotted module names; the leading axis of a
    :data:`STACKED` subtree becomes the ``ModuleList`` index."""
    for key, node in tree.items():
        name = prefix + key
        if key in STACKED and not prefix:
            leaves: Dict[str, np.ndarray] = {}
            _flatten(node, "", leaves)
            n = {v.shape[0] for v in leaves.values()}
            if len(n) != 1:
                raise ValueError(f"{key}: leaves disagree on the layer axis "
                                 f"({sorted(n)})")
            for i in range(n.pop()):
                for leaf, v in leaves.items():
                    out[f"{name}.{i}.{leaf}"] = v[i]
        elif isinstance(node, dict):
            _flatten(node, name + ".", out)
        else:
            out[name] = np.asarray(node)


def params_from_numpy(cfg, tree, device="cuda") -> Model:
    """A :class:`Model` holding the reference's ``Model(cfg).init`` pytree,
    given as numpy arrays (bfloat16 ones as ``ml_dtypes`` arrays or
    already cast to float32).  The stacked layer axis is unstacked; every
    leaf is copied, never transposed.  Raises ``ValueError`` when a
    parameter has no leaf, a leaf has no parameter, or a shape or dtype
    differs."""
    model = Model(cfg, device=device)
    leaves: Dict[str, np.ndarray] = {}
    _flatten(tree, "", leaves)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(leaves))
    extra = sorted(set(leaves) - set(params))
    if missing or extra:
        raise ValueError(f"{cfg.name}: parameters with no leaf {missing}, "
                         f"leaves with no parameter {extra}")
    with torch.no_grad():
        for name, p in params.items():
            v = leaves[name]
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"{name}: leaf shape {tuple(v.shape)} != "
                                 f"parameter {tuple(p.shape)}")
            if str(v.dtype) not in ("float32", str(p.dtype).split(".")[-1]):
                raise ValueError(f"{name}: leaf dtype {v.dtype} for a "
                                 f"{p.dtype} parameter")
            p.copy_(torch.from_numpy(np.array(v, dtype=np.float32)))
    return model


def params_to_numpy(model: Model) -> Dict[str, Any]:
    """The inverse of :func:`params_from_numpy`: the model's weights as the
    reference's ``Model.init`` pytree, leaf for leaf, as float32 numpy
    arrays on the host (layer lists stacked on a leading axis;
    ``nonparam_ln`` norms as empty dicts, as the reference keeps them).
    ``checkpoint.save_pytree`` writes it under the reference's key paths."""
    tree: Dict[str, Any] = {}
    for name, mod in model.named_modules():
        if isinstance(mod, Norm) and mod.w is None:
            _put(tree, name.split("."), {})
    for name, p in model.named_parameters():
        _put(tree, name.split("."), p.detach().float().cpu().numpy())
    for key in STACKED:
        if key in tree:
            tree[key] = _stack([tree[key][str(i)]
                                for i in range(len(tree[key]))])
    return tree


def _put(tree: Dict[str, Any], path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _stack(layers):
    if isinstance(layers[0], dict):
        return {k: _stack([layer[k] for layer in layers]) for k in layers[0]}
    return np.stack(layers)
