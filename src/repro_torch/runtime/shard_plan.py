"""Sharding plans: FlexPie's scheme alphabet mapped onto the production
mesh (the port of the JAX package's ``runtime/shard_plan.py``).

The edge planner chooses (partition scheme, T/NT) per layer; here the same
decision surfaces as a :class:`Strategy` per block-class:

  * ``attn``: ``"tp"`` (shard head projections over ``model`` — the OutC
    analogue) or ``"sp"`` (replicate weights, shard activations by sequence —
    the InH analogue).
  * ``ffn``:  ``"tp"`` or ``"sp"`` likewise for the MLP.
  * ``moe``:  ``"ep"`` (experts over ``model`` — expert parallel) or
    ``"tp"`` (expert FFN dim over ``model``).
  * ``fsdp``: shard every weight over the data axes as well (ZeRO-3); the
    per-layer weight all-gather is the T-mode re-layout of the mesh mapping.

Every rule is divisibility-checked against the mesh; infeasible choices fall
back (e.g. 40 heads on a 16-way model axis -> flattened-dim sharding or
replication), mirroring the paper's observation that scheme feasibility
depends on the layer/testbed pair.

PyTorch has no ``PartitionSpec``: :class:`P` stands in for it, a tuple whose
entries are an axis name, ``None`` or a tuple of names, one per leading
dimension (missing trailing entries replicate).  The port's parameters are
per layer (``blocks.3.attn.wq`` is ``[d, H·hd]``, with no stacked layer
axis), so a leaf's spec here is the reference's spec of the stacked leaf
(``blocks/attn/wq``) with its leading ``None`` dropped.  Trees are the
port's: parameters by dotted name (``Model.named_parameters()``), the
cache as nested dicts and lists; a leaf is anything with a ``shape``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Tuple


class P(tuple):
    """A partition spec: ``P("model", None)``, ``P(("pod", "data"),
    "model")``, ``P()`` (replicated).  A tuple of one axis name is that
    name, as ``PartitionSpec`` normalizes it."""

    def __new__(cls, *dims):
        return super().__new__(cls, (d[0] if isinstance(d, tuple)
                                     and len(d) == 1 else d for d in dims))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Strategy:
    attn: str = "tp"        # tp | sp
    ffn: str = "tp"         # tp | sp
    moe: str = "ep"         # ep | tp
    fsdp: bool = True
    # decode: resident TP weights (no data-axis sharding) when the model fits
    decode_resident: bool = False


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _fits(shape: Tuple[int, ...], spec: P, mesh) -> bool:
    for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                         - len(spec))):
        if axes is None:
            continue
        if dim % _axis_size(mesh, axes) != 0:
            return False
    return True


def _pick(shape, mesh, *candidates: P) -> P:
    """First candidate whose named axes all divide; else fully replicated."""
    for c in candidates:
        if _fits(shape, c, mesh):
            return c
    return P()


def local_shape(shape, spec: P, mesh) -> Tuple[int, ...]:
    """The shard of a ``shape`` tensor laid out as ``spec`` that one card
    holds, as XLA's ``NamedSharding`` gives it: each sharded dimension
    divided by its axes' size, rounded up (XLA pads a dimension that does
    not divide)."""
    dims = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-int(n) // _axis_size(mesh, a))
                 for n, a in zip(shape, dims))


# ---------------------------------------------------------------------------
# Parameter sharding rules
# ---------------------------------------------------------------------------

def _leaf_spec(path: str, shape: Tuple[int, ...], mesh, st: Strategy,
               mode: str) -> P:
    """Sharding rule for one parameter leaf.  ``path`` is the parameter's
    dotted name; every leaf is one layer's (no stacked axis)."""
    core = tuple(shape)
    fsdp = data_axes(mesh) if (st.fsdp and not (mode != "train"
                                                and st.decode_resident)) \
        else None
    name = path.split(".")[-1]

    # ---- scalars / vectors -------------------------------------------------
    if len(core) == 1:
        if name in ("bq", "bk", "bv") and st.attn == "tp":
            return _pick(core, mesh, P("model"))
        return P()

    # ---- embeddings / heads -----------------------------------------------
    if name == "tok_emb":
        return _pick(core, mesh, P("model", fsdp), P(None, "model"), P())
    if name == "lm_head":
        return _pick(core, mesh, P(fsdp, "model"), P("model", None), P())

    # ---- MoE ----------------------------------------------------------------
    if name == "router":
        return _pick(core, mesh, P(fsdp, None))
    if len(core) == 3 and name in ("w_gate", "w_up", "w_down"):
        # expert weights [E, d, f] / [E, f, d]
        if st.moe == "ep":
            cand = [P("model", fsdp, None), P(None, fsdp, "model"),
                    P(None, "model", fsdp)]
        else:
            cand = [P(None, fsdp, "model"), P(None, "model", fsdp),
                    P("model", fsdp, None)]
        return _pick(core, mesh, *cand)

    # ---- MLA ----------------------------------------------------------------
    if name in ("w_uk", "w_uv"):          # [H, a, b]
        return _pick(core, mesh, P("model", None, None), P())
    if name in ("w_dq", "w_dkv", "w_kr"):
        return _pick(core, mesh, P(fsdp, None))
    if name == "w_uq":
        if st.attn == "tp":
            return _pick(core, mesh, P(fsdp, "model"), P(fsdp, None))
        return _pick(core, mesh, P(fsdp, None))

    # ---- attention ----------------------------------------------------------
    if name in ("wq", "wk", "wv"):
        if st.attn == "tp":
            return _pick(core, mesh, P(fsdp, "model"), P(fsdp, None))
        return _pick(core, mesh, P(fsdp, None))
    if name == "wo":
        if st.attn == "tp":
            return _pick(core, mesh, P("model", fsdp), P(None, fsdp))
        return _pick(core, mesh, P(None, fsdp))

    # ---- dense MLP / rwkv channel-mix ---------------------------------------
    if name in ("w_gate", "w_up", "cm_k"):
        if st.ffn == "tp":
            return _pick(core, mesh, P(fsdp, "model"), P(fsdp, None))
        return _pick(core, mesh, P(fsdp, None))
    if name in ("w_down", "cm_v"):
        if st.ffn == "tp":
            return _pick(core, mesh, P("model", fsdp), P(None, fsdp))
        return _pick(core, mesh, P(None, fsdp))
    if name in ("b_up", "b_down"):
        return P()

    # ---- mamba2 / rwkv6 -----------------------------------------------------
    if name in ("w_z", "w_x"):
        return _pick(core, mesh, P(fsdp, "model"), P(fsdp, None))
    if name in ("w_b", "w_c", "w_dt"):
        return _pick(core, mesh, P(fsdp, None))
    if name == "conv_w":
        return _pick(core, mesh, P(None, "model"), P())
    if name in ("w_r", "w_k", "w_v", "w_g", "w_decay"):
        return _pick(core, mesh, P(fsdp, "model"), P(fsdp, None))
    if name == "w_out":
        return _pick(core, mesh, P("model", fsdp), P(None, fsdp))

    # ---- default: FSDP on dim 0 --------------------------------------------
    if len(core) >= 2:
        return _pick(core, mesh, P(fsdp, None), P())
    return P()


def _named_leaves(params) -> Mapping[str, Any]:
    if isinstance(params, Mapping):
        return params
    return dict(params.named_parameters())        # a Model


def param_specs(params, mesh, st: Strategy,
                mode: str = "train") -> Dict[str, P]:
    """Spec of every parameter, by name; ``params`` is a ``Model`` or a
    mapping of dotted names to tensors (or anything with a ``shape``)."""
    return {n: _leaf_spec(n, tuple(t.shape), mesh, st, mode)
            for n, t in _named_leaves(params).items()}


# ---------------------------------------------------------------------------
# Batch / cache / optimizer sharding
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree, path: str = ""):
    """``fn(path, leaf)`` over the dicts, lists and tuples of ``tree``;
    ``path`` joins keys and indices with dots."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, f"{path}.{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        out = [tree_map(fn, v, f"{path}.{i}" if path else str(i))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(path, tree)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(lambda _, leaf: out.append(leaf), tree)
    return out


def batch_specs(batch_shape, mesh) -> Any:
    dp = data_axes(mesh)

    def spec(_, leaf):
        shape = tuple(leaf.shape)
        if shape and shape[0] % _axis_size(mesh, dp) == 0:
            return P(dp, *([None] * (len(shape) - 1)))
        return P(*([None] * len(shape)))
    return tree_map(spec, batch_shape)


def cache_specs(cache_shape, mesh, st: Strategy) -> Any:
    """KV caches / SSM states (per-layer pages, batch-first): batch over the
    data axes; the largest remaining divisible dim (kv-heads, sequence or
    features) over ``model`` — flash-decode style sequence sharding falls
    out naturally when kv-heads don't divide the model axis.  The port's
    GQA caches also hold the decode kernel's page ``table`` (one int32
    vector every layer shares, not batch-first): replicated."""
    dp = data_axes(mesh)
    dpn = _axis_size(mesh, dp)
    msize = mesh.shape["model"]

    def spec(path, leaf) -> P:
        shape = tuple(leaf.shape)
        if path.split(".")[-1] == "table":
            return P(*([None] * len(shape)))
        dims: list = [None] * len(shape)
        if shape and shape[0] % dpn == 0 and shape[0] > 1:
            dims[0] = dp
        best, best_dim = 0, -1
        for i in range(1, len(shape)):
            if shape[i] % msize == 0 and shape[i] > best:
                best, best_dim = shape[i], i
        if best_dim >= 0:
            dims[best_dim] = "model"
        return P(*dims)

    return tree_map(spec, cache_shape)


def opt_specs(param_spec_tree, params_shape=None) -> Dict[str, Any]:
    """AdamW moments inherit their parameter's sharding; step is replicated."""
    return {"m": param_spec_tree, "v": param_spec_tree, "step": P()}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to its mesh (the counterpart of JAX's
    ``NamedSharding``): :meth:`shard_shape` is one card's shard."""
    mesh: Any
    spec: P

    def shard_shape(self, shape) -> Tuple[int, ...]:
        return local_shape(shape, self.spec, self.mesh)


def named(tree_of_specs, mesh):
    return tree_map(lambda _, s: NamedSharding(mesh, s), tree_of_specs)
