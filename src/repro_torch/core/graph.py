"""Layer-graph IR for the edge-inference planner.

FlexPie consumes a computation graph of DNN layers (Fig. 3).  The IR is a
DAG of :class:`LayerSpec` nodes: each layer names its producers via
``inputs`` (empty = the previous layer in the tuple, which keeps plain
chains working with zero changes).  Multi-input merge layers (``ADD``,
``CONCAT``) carry real branch structure — residual blocks and
Inception-style modules are no longer folded into ``extra_flop_factor``.
:meth:`ModelGraph.linearize` decomposes the DAG into chain *branches*
joined at fork/merge junctions; the planner, cost model and engine all
operate per-branch and compose at the junctions.  The real tensor programs
live in ``repro_torch/runtime/engine.py``; this IR is what the
combinatorial optimizer reasons about.

A copy of the JAX package's ``core/graph.py`` (pure Python): the port
keeps its own so that it never imports the reference package.
"""
from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Dict, List, Sequence, Tuple

#: Sentinel producer name meaning "the graph input tensor".
GRAPH_INPUT = "@input"


class ConvT(enum.IntEnum):
    """Layer categories (the ``ConvT`` categorical feature of Fig. 4)."""

    CONV = 0          # standard convolution
    DWCONV = 1        # depthwise convolution
    POINTWISE = 2     # 1x1 convolution
    POOL = 3          # max/avg pool (no weights)
    FC = 4            # fully connected / matmul (BERT, classifier heads)
    ADD = 5           # residual add (elementwise, multi-input merge)
    CONCAT = 6        # channel concatenation (Inception-style merge)
    ATTN = 7          # fused attention block (QKV + scores + out proj)
    FFN = 8           # fused transformer FFN (up proj + act + down proj)


#: Layer types allowed to have fan-in >= 2.
MERGE_TYPES = (ConvT.ADD, ConvT.CONCAT)

#: Transformer block layer types (sequence lives in ``in_h``, like FC).
ATTN_TYPES = (ConvT.ATTN, ConvT.FFN)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer of the inference graph.

    Shapes follow the paper's feature expression (Fig. 4): input feature map
    ``InH x InW x InC``, output ``OutH x OutW x OutC``, kernel ``K``, stride
    ``S``, padding ``P``.  For FC/matmul layers the convention is
    ``InH = OutH = seq_len`` (BERT tokens), ``InW = OutW = 1``,
    ``InC/OutC = feature dims`` and ``K = S = 1, P = 0``.

    ``inputs`` names this layer's producers.  Empty means "the previous
    layer in the graph tuple" (the chain-compat default; the graph input for
    layer 0).  Merge layers (``ADD``/``CONCAT``) list two or more producers;
    ``ADD`` inputs must agree on all dims, ``CONCAT`` inputs must agree
    spatially and their channels sum to ``in_c``.  :data:`GRAPH_INPUT`
    refers to the raw graph input (multi-tower models).

    Transformer blocks follow the FC convention (``InH = seq_len``,
    ``InW = 1``, ``K = S = 1, P = 0``): ``ATTN`` is a fused attention block
    (pre-norm + QKV projections + scaled-dot-product attention + output
    projection + residual) whose head count geometry lives in ``heads`` —
    OutC partitions split at *head* granularity, never inside a head —
    with the score/AV work (which scales with the attended KV length, not
    a weight shape) folded into ``extra_flop_factor`` by the graph
    constructor.  ``FFN`` is the fused two-matmul MLP; its hidden width is
    likewise folded (``extra_flop_factor = 2 * d_ff / d_model``).
    """

    name: str
    conv_t: ConvT
    in_h: int
    in_w: int
    in_c: int
    out_c: int
    k: int = 1
    s: int = 1
    p: int = 0
    extra_flop_factor: float = 1.0  # folds activations / attention scores
    inputs: Tuple[str, ...] = ()    # producer names; () = chain default
    heads: int = 0                  # ATTN head count (0 = not an ATTN layer)

    @property
    def out_h(self) -> int:
        return (self.in_h + 2 * self.p - self.k) // self.s + 1

    @property
    def out_w(self) -> int:
        return (self.in_w + 2 * self.p - self.k) // self.s + 1

    @property
    def fan_in(self) -> int:
        """Number of producer tensors (1 for chain-default layers)."""
        return max(1, len(self.inputs))

    # ---- workload ---------------------------------------------------------
    def flops(self) -> float:
        """Total MACs*2 for the full (unpartitioned) layer."""
        oh, ow = self.out_h, self.out_w
        if self.conv_t == ConvT.CONV or self.conv_t == ConvT.POINTWISE:
            f = 2.0 * oh * ow * self.out_c * self.in_c * self.k * self.k
        elif self.conv_t == ConvT.DWCONV:
            f = 2.0 * oh * ow * self.out_c * self.k * self.k
        elif self.conv_t == ConvT.POOL:
            f = 1.0 * oh * ow * self.out_c * self.k * self.k
        elif self.conv_t == ConvT.FC:
            f = 2.0 * self.in_h * self.in_c * self.out_c
        elif self.conv_t == ConvT.ADD:
            # (fan_in - 1) elementwise adds; the folded chain form counts one
            f = max(1, self.fan_in - 1) * 1.0 * oh * ow * self.out_c
        elif self.conv_t == ConvT.CONCAT:
            f = 1.0 * oh * ow * self.out_c   # copy cost
        elif self.conv_t in (ConvT.ATTN, ConvT.FFN):
            # projection MACs; scores/AV (ATTN) and the hidden width (FFN)
            # ride in extra_flop_factor (set by the graph constructor)
            f = 2.0 * self.in_h * self.in_c * self.out_c
        else:  # pragma: no cover - exhaustive enum
            raise ValueError(self.conv_t)
        return f * self.extra_flop_factor

    def out_elems(self) -> int:
        return self.out_h * self.out_w * self.out_c

    def in_elems(self) -> int:
        return self.in_h * self.in_w * self.in_c

    def weight_elems(self) -> int:
        if self.conv_t in (ConvT.CONV, ConvT.POINTWISE):
            return self.k * self.k * self.in_c * self.out_c
        if self.conv_t == ConvT.DWCONV:
            return self.k * self.k * self.out_c
        if self.conv_t == ConvT.FC:
            return self.in_c * self.out_c
        if self.conv_t == ConvT.ATTN:
            return 4 * self.in_c * self.out_c   # wq, wk, wv, wo
        if self.conv_t == ConvT.FFN:
            # 2 * d * d_ff, recovered from the folded hidden-width factor
            return int(self.in_c * self.out_c * self.extra_flop_factor)
        return 0

    def feature_vector(self) -> Tuple[float, ...]:
        """Shape + structure part of the feature expression (12 values; see
        ``I_FEATURE_NAMES``/``S_FEATURE_NAMES`` in ``core/estimator.py`` for
        the full i-/s-feature layouts these embed into)."""
        return (
            float(self.in_h), float(self.in_w), float(self.in_c),
            float(self.out_h), float(self.out_w), float(self.out_c),
            float(self.k), float(self.s), float(self.p), float(self.conv_t),
            float(self.fan_in), float(self.heads),
        )

    def with_input(self, in_h: int, in_w: int) -> "LayerSpec":
        return dataclasses.replace(self, in_h=in_h, in_w=in_w)


@dataclasses.dataclass(frozen=True)
class Branch:
    """A maximal chain of layer indices between junctions of the DAG."""

    ids: Tuple[int, ...]

    @property
    def head(self) -> int:
        return self.ids[0]

    @property
    def tail(self) -> int:
        return self.ids[-1]

    def __len__(self) -> int:
        return len(self.ids)


@dataclasses.dataclass(frozen=True)
class ModelGraph:
    """DAG of layers, stored in topological order.

    Plain chains (no explicit ``inputs``) behave exactly as before:
    ``layers[i+1].in_* == layers[i].out_*`` must hold and every planner /
    engine path is unchanged.  Branched graphs additionally validate merge
    shapes, require a unique output layer in the last position, and expose
    the branch decomposition via :meth:`linearize`.
    """

    name: str
    layers: Tuple[LayerSpec, ...]

    def __post_init__(self) -> None:
        self._validate()

    # ---- structure --------------------------------------------------------
    @functools.cached_property
    def producer_ids(self) -> Tuple[Tuple[int, ...], ...]:
        """Resolved producer indices per layer; ``-1`` is the graph input."""
        counts: Dict[str, int] = {}
        for l in self.layers:
            counts[l.name] = counts.get(l.name, 0) + 1
        by_name: Dict[str, int] = {}
        out: List[Tuple[int, ...]] = []
        for i, l in enumerate(self.layers):
            if l.inputs:
                ids = []
                for nm in l.inputs:
                    if nm == GRAPH_INPUT:
                        ids.append(-1)
                        continue
                    if counts.get(nm, 0) > 1:
                        raise ValueError(
                            f"{self.name}: input {nm!r} of {l.name} is "
                            f"ambiguous (duplicate layer name)")
                    j = by_name.get(nm)
                    if j is None:
                        raise ValueError(
                            f"{self.name}: {l.name} references unknown or "
                            f"later layer {nm!r} (layers must be in "
                            f"topological order)")
                    ids.append(j)
                out.append(tuple(ids))
            else:
                out.append((i - 1,) if i else (-1,))
            by_name[l.name] = i
        return tuple(out)

    @functools.cached_property
    def consumer_ids(self) -> Tuple[Tuple[int, ...], ...]:
        cons: List[List[int]] = [[] for _ in self.layers]
        for i, prods in enumerate(self.producer_ids):
            for j in prods:
                if j >= 0:
                    cons[j].append(i)
        return tuple(tuple(c) for c in cons)

    def fan_in(self, i: int) -> int:
        return len(self.producer_ids[i])

    def fan_out(self, i: int) -> int:
        return len(self.consumer_ids[i])

    @functools.cached_property
    def is_chain(self) -> bool:
        """True iff every layer consumes exactly the previous one."""
        return all(prods == ((i - 1,) if i else (-1,))
                   for i, prods in enumerate(self.producer_ids))

    def _validate(self) -> None:
        prods = self.producer_ids
        if not self.layers:
            return
        l0 = self.layers[0]
        # the graph input's shape is fixed by layer 0's declared input
        in_shape = (l0.in_h, l0.in_w, l0.in_c)

        def pshape(j: int) -> Tuple[int, int, int]:
            if j < 0:
                return in_shape
            p = self.layers[j]
            return (p.out_h, p.out_w, p.out_c)

        def pname(j: int) -> str:
            return GRAPH_INPUT if j < 0 else self.layers[j].name

        for i, l in enumerate(self.layers):
            ins = prods[i]
            if len(ins) >= 2 and l.conv_t not in MERGE_TYPES:
                raise ValueError(
                    f"{self.name}: {l.name} ({l.conv_t.name}) has fan-in "
                    f"{len(ins)}; only ADD/CONCAT layers may merge")
            if l.conv_t in ATTN_TYPES and (l.k, l.s, l.p) != (1, 1, 0):
                raise ValueError(
                    f"{self.name}: {l.name} ({l.conv_t.name}) must have "
                    f"K=S=1, P=0 (sequence lives in InH)")
            if l.conv_t == ConvT.ATTN:
                if l.heads < 1 or l.out_c % l.heads:
                    raise ValueError(
                        f"{self.name}: ATTN {l.name} needs heads >= 1 "
                        f"dividing out_c (heads={l.heads}, out_c={l.out_c})")
            elif l.heads:
                raise ValueError(
                    f"{self.name}: {l.name} ({l.conv_t.name}) carries "
                    f"heads={l.heads}; only ATTN layers have head geometry")
            if l.conv_t == ConvT.ADD and len(ins) >= 2:
                for j in ins:
                    if pshape(j) != (l.in_h, l.in_w, l.in_c):
                        ph, pw, pc = pshape(j)
                        raise ValueError(
                            f"{self.name}: ADD {l.name} input {pname(j)} "
                            f"({ph},{pw},{pc}) != "
                            f"({l.in_h},{l.in_w},{l.in_c})")
                if l.out_c != l.in_c:
                    raise ValueError(f"{self.name}: ADD {l.name} must "
                                     f"preserve channels")
            elif l.conv_t == ConvT.CONCAT and len(ins) >= 2:
                for j in ins:
                    if pshape(j)[:2] != (l.in_h, l.in_w):
                        ph, pw, _ = pshape(j)
                        raise ValueError(
                            f"{self.name}: CONCAT {l.name} input "
                            f"{pname(j)} ({ph},{pw}) != "
                            f"({l.in_h},{l.in_w})")
                csum = sum(pshape(j)[2] for j in ins)
                if csum != l.in_c or l.out_c != l.in_c:
                    raise ValueError(
                        f"{self.name}: CONCAT {l.name} channels {csum} != "
                        f"in_c {l.in_c} (out_c {l.out_c})")
            elif i > 0 or ins[0] >= 0:
                ph, pw, pc = pshape(ins[0])
                if (ph, pw) != (l.in_h, l.in_w) or pc != l.in_c:
                    raise ValueError(
                        f"{self.name}: layer chain mismatch {pname(ins[0])} "
                        f"({ph},{pw},{pc}) -> {l.name} "
                        f"({l.in_h},{l.in_w},{l.in_c})")
        if not self.is_chain and self.layers:
            sinks = [i for i in range(len(self.layers))
                     if not self.consumer_ids[i]]
            if len(sinks) != 1 or sinks[0] != len(self.layers) - 1:
                raise ValueError(
                    f"{self.name}: branched graph must have exactly one "
                    f"output layer, placed last (sinks: "
                    f"{[self.layers[i].name for i in sinks]})")

    @functools.cached_property
    def _branches(self) -> Tuple[Branch, ...]:
        prods, cons = self.producer_ids, self.consumer_ids
        branch_of: Dict[int, int] = {}
        chains: List[List[int]] = []
        for i in range(len(self.layers)):
            p = prods[i]
            extend = (len(p) == 1 and p[0] >= 0 and len(cons[p[0]]) == 1)
            if extend:
                bi = branch_of[p[0]]
                chains[bi].append(i)
            else:
                bi = len(chains)
                chains.append([i])
            branch_of[i] = bi
        return tuple(Branch(tuple(c)) for c in chains)

    def linearize(self) -> Tuple[Branch, ...]:
        """Decompose the DAG into chain branches cut at every fork output
        and merge input.  Branches are returned in topological order (head
        index ascending); every cross-branch producer is a branch tail."""
        return self._branches

    def __len__(self) -> int:
        return len(self.layers)

    def total_flops(self) -> float:
        return sum(l.flops() for l in self.layers)

    def spatial(self) -> bool:
        """True if the graph has spatial (conv) layers at all."""
        return any(l.conv_t in (ConvT.CONV, ConvT.DWCONV, ConvT.POINTWISE,
                                ConvT.POOL) for l in self.layers)


# ---------------------------------------------------------------------------
# Kernel-geometry helpers — the conformance-grid axes for the Pallas shard
# kernels (tests/test_kernel_conformance.py sweeps every key returned here).
# ---------------------------------------------------------------------------

def conv_geometries(graph: "ModelGraph"
                    ) -> Tuple[Tuple[ConvT, int, int, int], ...]:
    """All distinct ``(conv_t, k, s, p)`` geometry keys occurring in the
    graph, sorted.  This is exactly the set of per-layer kernel geometries a
    backend must support (or cleanly fall back on) to execute the model."""
    return tuple(sorted({(l.conv_t, l.k, l.s, l.p) for l in graph.layers}))


def shard_halo_pads(p: int) -> Tuple[Tuple[int, int, int, int], ...]:
    """The distinct ``(top, bottom, left, right)`` zero-pad signatures a
    shard of a ``p``-padded conv can occupy under the spatial schemes: a
    corner / edge / interior cell of a 2-D grid sees the map padding only on
    its outward sides — inward sides carry real halo rows instead (the 1-D
    InH/InW splits are the edge-row/col subsets).  ``p == 0`` collapses to
    the single all-zero signature."""
    tb = [(p, p), (p, 0), (0, 0), (0, p)] if p else [(0, 0)]
    return tuple(dict.fromkeys(
        (t, b, lft, r) for t, b in tb for lft, r in tb))


# ---------------------------------------------------------------------------
# Receptive-field math — the heart of NT-mode (redundant-compute) planning.
# ---------------------------------------------------------------------------

def halo_growth(layers: Sequence[LayerSpec], upto: int) -> List[int]:
    """Cumulative output-halo each layer must additionally produce so that
    layer ``upto`` can be computed with zero communication (NT fusion).

    ``halo[m]`` = number of extra *output* rows (per side) layer ``m`` must
    compute, given layers ``m+1..upto`` are fused after it.  ``halo[upto] = 0``.
    Standard receptive-field recurrence, applied backwards:
        need[m] = need[m+1] * S_{m+1} + (K_{m+1} - 1)   (in layer-m output rows)
    For FC/ADD/CONCAT layers K=S=1 so the halo never grows through them.
    An ATTN layer attends over the whole sequence, so its receptive field
    is the full ``in_h`` extent: fusing *into* attention means every shard
    recomputes the entire prefix, and the recurrence charges exactly that
    (the planner then prices NT-through-ATTN as full replication and puts a
    T boundary there instead).
    ``layers`` is a chain (one branch of the DAG); NT fusion never crosses
    fork/merge junctions, so the recurrence stays 1-D.
    """
    n = upto + 1
    halo = [0] * n
    for m in range(upto - 1, -1, -1):
        nxt = layers[m + 1]
        grow = nxt.in_h if nxt.conv_t == ConvT.ATTN else (nxt.k - 1)
        halo[m] = halo[m + 1] * nxt.s + grow
    return halo


def chain(name: str, specs: Sequence[LayerSpec],
          drop_edges: bool = False) -> ModelGraph:
    """Chain-compat constructor: each layer consumes the previous one.

    Layers carrying explicit ``inputs`` edges are rejected — silently
    re-chaining them would build a semantically different model (residual
    ADDs degrade to the identity).  Pass ``drop_edges=True`` to strip the
    edges on purpose (e.g. to compare a DAG against its chain skeleton).
    """
    if any(l.inputs for l in specs):
        if not drop_edges:
            bad = [l.name for l in specs if l.inputs]
            raise ValueError(
                f"{name}: layers {bad} carry DAG input edges; build a "
                f"ModelGraph directly, or pass drop_edges=True to chain() "
                f"to deliberately discard them")
        specs = tuple(dataclasses.replace(l, inputs=()) if l.inputs else l
                      for l in specs)
    return ModelGraph(name=name, layers=tuple(specs))
