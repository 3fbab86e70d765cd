"""Histogram-based regression tree — the GBDT's weak learner, on tensors.

The second-order gain with L2 regularization of the JAX package's
``repro/gbdt/tree.py``:

    gain = 1/2 * [ GL^2/(HL+lam) + GR^2/(HR+lam) - G^2/(H+lam) ] - gamma

For squared error, g = (pred - y), h = 1.  Features are pre-binned into
quantile bins once per GBDT fit.

The reference grows a tree depth first, one node at a time.  This one
grows it level by level, which is the GPU's idiom: each depth makes one
histogram of shape ``[nodes_at_depth, F, n_bins]`` for ``grad`` and
``hess``, one running sum over the bins, and the gain, validity and split
choice of every node at once; then the nodes are renumbered into the
reference's preorder, so the flat arrays (and the npz files) compare node
for node.  The split rule is the reference's to the letter: ragged bins
per feature, ``-inf`` gain for an invalid side, the first bin of highest
gain within a feature, the earlier feature on a tie across features, the
same stop rules and leaf values.

The arithmetic follows the reference's order, so a fit on CPU tensors
gives the reference's forest bit for bit:

* node sums are numpy's ``ndarray.sum`` order (:func:`segment_sums`: a
  pairwise sum within each 8192-element buffer, the buffers added in
  turn from 0.0);
* histograms go through ``index_put_(accumulate=True)``, which sums each
  bin's rows in row order on the CPU (``np.add.at``'s order); on CUDA it
  sorts the keys and sums each bin's run in one thread, deterministic
  (no atomics), in an order the card's PyTorch build decides;
* the running sums over bins are explicit adds in bin order
  (``np.cumsum``'s order), since CUDA's ``cumsum`` scans in parallel.

Inference descends every row in lockstep through the flat arrays (one
gather and one compare per level); ``predict_reference`` keeps the
one-sample-at-a-time walk over the host node list as the parity oracle.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class _Node:
    feature: int = -1
    threshold: float = 0.0     # raw-value threshold (go left if x <= thr)
    left: int = -1
    right: int = -1
    value: float = 0.0
    is_leaf: bool = True


#: Flat structure-of-arrays form of a fitted tree:
#: (feature i32, threshold f64, left i32, right i32, value f64, is_leaf bool)
FlatTree = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                 np.ndarray]


def flatten_nodes(nodes: List[_Node]) -> FlatTree:
    feature = np.fromiter((n.feature for n in nodes), np.int32, len(nodes))
    threshold = np.fromiter((n.threshold for n in nodes), np.float64,
                            len(nodes))
    left = np.fromiter((n.left for n in nodes), np.int32, len(nodes))
    right = np.fromiter((n.right for n in nodes), np.int32, len(nodes))
    value = np.fromiter((n.value for n in nodes), np.float64, len(nodes))
    is_leaf = np.fromiter((n.is_leaf for n in nodes), np.bool_, len(nodes))
    return feature, threshold, left, right, value, is_leaf


def nodes_from_flat(flat: Sequence[np.ndarray]) -> List[_Node]:
    feature, threshold, left, right, value, is_leaf = flat
    return [_Node(int(f), float(t), int(lo), int(r), float(v), bool(lf))
            for f, t, lo, r, v, lf in zip(feature, threshold, left, right,
                                          value, is_leaf)]


def tree_depth(left: np.ndarray, right: np.ndarray,
               is_leaf: np.ndarray) -> int:
    """Edges on the longest root-to-leaf path of a flat tree."""
    if len(is_leaf) == 0:
        return 0
    depth, frontier = 0, [0]
    while True:
        frontier = [c for i in frontier if not is_leaf[i]
                    for c in (int(left[i]), int(right[i]))]
        if not frontier:
            return depth
        depth += 1


# ---------------------------------------------------------------------------
# numpy's summation order on tensors
# ---------------------------------------------------------------------------

#: numpy's pairwise-sum leaf size (``PW_BLOCKSIZE``) and its ufunc buffer:
#: ``ndarray.sum`` adds one pairwise sum per buffer, in turn, from 0.0
_PW_BLOCK = 128
_NP_BUFSIZE = 8192


def _pairwise_plan(starts: np.ndarray, lens: np.ndarray):
    """Split each interval the way numpy's ``pairwise_sum`` recurses: an
    interval longer than ``_PW_BLOCK`` becomes ``n2 = n // 2 - (n // 2) % 8``
    elements and the rest.  Returns the leaves ``(ids, starts, lens)`` and
    the combine rounds ``[(parent, left, right), ...]`` in split order;
    ids ``< len(starts)`` are the input intervals."""
    ids = np.arange(len(starts))
    next_id = len(starts)
    leaves, rounds = [], []
    while ids.size:
        big = lens > _PW_BLOCK
        leaves.append((ids[~big], starts[~big], lens[~big]))
        if not big.any():
            break
        p, s, n = ids[big], starts[big], lens[big]
        n2 = n // 2
        n2 -= n2 % 8
        k = p.size
        lid = next_id + np.arange(k)
        rid = next_id + k + np.arange(k)
        next_id += 2 * k
        rounds.append((p, lid, rid))
        ids = np.concatenate([lid, rid])
        starts = np.concatenate([s, s + n2])
        lens = np.concatenate([n2, n - n2])
    leaf = tuple(np.concatenate(parts) for parts in zip(*leaves))
    return leaf, rounds, next_id


def _block_sums(v: torch.Tensor, starts: torch.Tensor,
                lens: torch.Tensor) -> torch.Tensor:
    """numpy's ``pairwise_sum`` of intervals of at most ``_PW_BLOCK`` rows
    of ``v`` ``[L, C]``: under 8 elements a running sum from 0.0; else
    eight running sums over the multiple-of-8 prefix, combined
    ``((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7))``, then the rest one by one."""
    B, C = starts.shape[0], v.shape[1]
    lane = torch.arange(_PW_BLOCK, device=v.device)
    idx = starts[:, None] + lane[None, :]
    inside = lane[None, :] < lens[:, None]
    a = torch.where(inside[..., None],
                    v[idx.clamp(max=max(v.shape[0] - 1, 0))],
                    torch.zeros((), dtype=v.dtype, device=v.device))
    q = lens // 8
    r = a[:, 0:8]
    for k in range(1, _PW_BLOCK // 8):
        r = torch.where((k < q)[:, None, None], r + a[:, 8 * k:8 * k + 8], r)
    comb = ((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3])) + \
        ((r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7]))
    res = torch.where((q > 0)[:, None], comb,
                      torch.zeros((B, C), dtype=v.dtype, device=v.device))
    rows = torch.arange(B, device=v.device)
    for t in range(7):
        pos = 8 * q + t
        res = torch.where((pos < lens)[:, None],
                          res + a[rows, pos.clamp(max=_PW_BLOCK - 1)], res)
    return res


def segment_sums(v: torch.Tensor, counts: Sequence[int]) -> torch.Tensor:
    """``np.sum`` of each contiguous segment of ``v`` ``[L, C]`` (segment
    ``k`` is the next ``counts[k]`` rows), column by column, bit for bit:
    numpy's pairwise sum within each 8192-row buffer, the buffers added in
    turn from 0.0.  Only elementwise adds, so CPU and CUDA agree."""
    counts = np.asarray(counts, np.int64)
    K, C, dev = len(counts), v.shape[1], v.device
    nch = -(-counts // _NP_BUFSIZE)
    seg_starts = np.cumsum(counts) - counts
    seg_of = np.repeat(np.arange(K), nch)
    c_in = np.arange(nch.sum()) - np.repeat(np.cumsum(nch) - nch, nch)
    c_start = seg_starts[seg_of] + c_in * _NP_BUFSIZE
    c_len = np.minimum(_NP_BUFSIZE, counts[seg_of] - c_in * _NP_BUFSIZE)
    total = torch.zeros((K, C), dtype=v.dtype, device=dev)
    if c_start.size == 0:
        return total
    (lid, lst, lln), rounds, n_ids = _pairwise_plan(c_start, c_len)

    def dev_i64(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)

    vals = torch.empty((n_ids, C), dtype=v.dtype, device=dev)
    vals[dev_i64(lid)] = _block_sums(v, dev_i64(lst), dev_i64(lln))
    for parent, left, right in reversed(rounds):
        vals[dev_i64(parent)] = vals[dev_i64(left)] + vals[dev_i64(right)]
    # buffers in turn: chunk ids are 0..n_chunks-1 in segment order
    width = int(nch.max())
    first = np.cumsum(nch) - nch
    grid = np.minimum(first[:, None] + np.arange(width)[None, :],
                      len(c_start) - 1)
    chunk = vals[dev_i64(grid)]                       # [K, width, C]
    live = dev_i64(np.arange(width)[None, :] < nch[:, None]).bool()
    for j in range(width):
        total = torch.where(live[:, j, None], total + chunk[:, j], total)
    return total


# ---------------------------------------------------------------------------
# the tree
# ---------------------------------------------------------------------------

def walk(feature: torch.Tensor, threshold: torch.Tensor, left: torch.Tensor,
         right: torch.Tensor, is_leaf: torch.Tensor, x: torch.Tensor,
         depth: int) -> torch.Tensor:
    """Leaf index ``[T, n]`` of every row of ``x`` ``[n, F]`` in each of
    ``T`` trees given as ``[T, M]`` flat arrays (``feature`` clamped to
    be a valid column on leaves): ``depth`` lockstep steps; a row that
    reached a leaf stays on it."""
    T, n = feature.shape[0], x.shape[0]
    cur = torch.zeros((T, n), dtype=torch.int64, device=x.device)
    xt = x.t()
    for _ in range(depth):
        go_left = xt.gather(0, feature.gather(1, cur)) <= \
            threshold.gather(1, cur)
        nxt = torch.where(go_left, left.gather(1, cur), right.gather(1, cur))
        cur = torch.where(is_leaf.gather(1, cur), cur, nxt)
    return cur


class RegressionTree:
    def __init__(self, max_depth: int = 6, min_child_weight: float = 2.0,
                 reg_lambda: float = 1.0, gamma: float = 0.0,
                 device="cuda"):
        self.max_depth = max_depth
        self.min_child_weight = min_child_weight
        self.reg_lambda = reg_lambda
        self.gamma = gamma
        self.device = torch.device(device)
        # (feature, threshold, left, right, value, is_leaf) on the device
        self._arrays: Optional[Tuple[torch.Tensor, ...]] = None
        self._nodes: Optional[List[_Node]] = None
        self.depth = 0

    # ---- the node arrays and their host views ------------------------------
    @classmethod
    def from_flat(cls, flat: Sequence[np.ndarray],
                  device="cuda") -> "RegressionTree":
        """A fitted tree from the reference's flat node arrays (numpy)."""
        tree = cls(device=device)
        tree._set_flat([np.asarray(a) for a in flat])
        return tree

    def _set_flat(self, flat: Sequence[np.ndarray]) -> None:
        feature, threshold, left, right, value, is_leaf = flat
        self.depth = tree_depth(left, right, is_leaf)
        self._arrays = tuple(
            torch.from_numpy(np.ascontiguousarray(a, dt)).to(self.device)
            for a, dt in ((feature, np.int64), (threshold, np.float64),
                          (left, np.int64), (right, np.int64),
                          (value, np.float64), (is_leaf, np.bool_)))
        self._nodes = None

    @property
    def arrays(self) -> Tuple[torch.Tensor, ...]:
        """Device node arrays: feature (-1 on leaves), threshold, left,
        right (-1 on leaves), value, is_leaf."""
        if self._arrays is None:            # an unfitted tree
            self._set_flat(flatten_nodes([]))
        return self._arrays

    def flat(self) -> FlatTree:
        """Host structure-of-arrays copy, in the reference's dtypes."""
        f, t, lo, r, v, lf = (a.cpu().numpy() for a in self.arrays)
        return (f.astype(np.int32), t, lo.astype(np.int32),
                r.astype(np.int32), v, lf)

    @property
    def nodes(self) -> List[_Node]:
        """Host node list in the reference's preorder (made on demand)."""
        if self._nodes is None:
            self._nodes = nodes_from_flat(self.flat())
        return self._nodes

    @nodes.setter
    def nodes(self, nodes: List[_Node]) -> None:
        self._set_flat(flatten_nodes(nodes))
        self._nodes = list(nodes)

    def _leaf_value(self, g, h):
        return -g / (h + self.reg_lambda)

    # ---- fit ----------------------------------------------------------------
    # binned: (n, d) bin indices on the device; edges: per-feature bin edges
    # (host numpy); grad, hess: (n,) f64 on the device
    def fit(self, binned: torch.Tensor, edges: List[np.ndarray],
            grad: torch.Tensor, hess: torch.Tensor) -> "RegressionTree":
        dev = binned.device
        self.device = dev
        n, F = binned.shape
        lam, mcw = self.reg_lambda, self.min_child_weight
        nb = np.asarray([len(e) + 1 for e in edges], np.int64)
        NB = max(int(nb.max()) if F else 1, 2)
        # split position b < nb_f - 1 exists (np.cumsum(gh)[:-1]); a feature
        # with nb <= 1 has none
        pos_ok = torch.from_numpy(
            np.arange(NB - 1)[None, :] < (nb - 1)[:, None]).to(dev)
        thr_tab = np.zeros((F, NB - 1))
        for f, e in enumerate(edges):
            thr_tab[f, :len(e)] = e
        thr_tab = torch.from_numpy(thr_tab).to(dev)
        feat_ids = torch.arange(F, device=dev)
        gh = torch.stack([grad, hess], 1)

        order = torch.arange(n, device=dev)
        counts = [n]
        levels = []     # per depth: (value, split, feature, threshold)
        for depth in range(self.max_depth + 1):
            K = len(counts)
            gh_o = gh[order]
            sums = segment_sums(gh_o, counts)
            g_sum, h_sum = sums[:, 0], sums[:, 1]
            value = self._leaf_value(g_sum, h_sum)
            if depth == self.max_depth:
                levels.append((value, np.zeros(K, bool),
                               torch.full((K,), -1, device=dev),
                               torch.zeros_like(value)))
                break
            cnt = torch.tensor(counts, device=dev)
            can = (h_sum >= 2 * mcw) & (cnt >= 2)
            node_of = torch.repeat_interleave(torch.arange(K, device=dev),
                                              cnt, output_size=len(order))
            xb = binned[order]
            keys = (node_of[:, None] * F + feat_ids[None, :]) * NB + xb
            hist = torch.zeros((K * F * NB, 2), dtype=gh.dtype, device=dev)
            hist.index_put_((keys.reshape(-1),),
                            gh_o[:, None, :].expand(-1, F, -1).reshape(-1, 2),
                            accumulate=True)
            cum = hist.view(K, F, NB, 2)
            for b in range(1, NB - 1):
                cum[:, :, b] += cum[:, :, b - 1]
            gl, hl = cum[:, :, :NB - 1, 0], cum[:, :, :NB - 1, 1]
            gr = g_sum[:, None, None] - gl
            hr = h_sum[:, None, None] - hl
            valid = (hl >= mcw) & (hr >= mcw) & pos_ok[None]
            parent = g_sum * g_sum / (h_sum + lam)
            gains = (gl * gl / (hl + lam) + gr * gr / (hr + lam)
                     - parent[:, None, None])
            gains = torch.where(valid, gains, -torch.inf)
            fgain, fbin = gains.max(dim=2)      # first bin of highest gain
            best = torch.zeros(K, dtype=gh.dtype, device=dev)
            best_f = torch.full((K,), -1, dtype=torch.int64, device=dev)
            best_b = torch.full((K,), -1, dtype=torch.int64, device=dev)
            for f in range(F):                  # the earlier feature on a tie
                better = fgain[:, f] > best + 2 * self.gamma
                best = torch.where(better, fgain[:, f], best)
                best_f = torch.where(better, f, best_f)
                best_b = torch.where(better, fbin[:, f], best_b)
            split_d = can & (best_f >= 0)
            bf, bb = best_f.clamp(min=0), best_b.clamp(min=0)
            threshold = torch.where(split_d, thr_tab[bf, bb],
                                    torch.zeros((), dtype=gh.dtype,
                                                device=dev))
            split = split_d.cpu().numpy()
            levels.append((value, split, torch.where(split_d, best_f, -1),
                           threshold))
            if not split.any():
                break
            # children: rows of a split node go left (x_bin <= b) or right,
            # keeping row order; child 2r / 2r+1 of the r-th split node
            rank = torch.cumsum(split_d.long(), 0) - 1
            rows = split_d[node_of]
            xb_f = xb.gather(1, bf[node_of][:, None])[:, 0]
            child = 2 * rank[node_of] + (xb_f > bb[node_of]).long()
            child, order = child[rows], order[rows]
            child, perm = torch.sort(child, stable=True)
            order = order[perm]
            counts = torch.bincount(child, minlength=2 * int(split.sum())
                                    ).cpu().tolist()
        self._assemble(levels)
        return self

    def _assemble(self, levels) -> None:
        """Renumber the level-wise nodes into the reference's preorder
        (node, left subtree, right subtree) and build the flat arrays."""
        splits = [lv[1] for lv in levels]
        ranks = [np.cumsum(s) - 1 for s in splits]
        order = []                               # (depth, index) in preorder
        stack = [(0, 0)]
        while stack:
            d, j = stack.pop()
            order.append((d, j))
            if splits[d][j]:
                r = ranks[d][j]
                stack += [(d + 1, 2 * r + 1), (d + 1, 2 * r)]
        pre = {key: i for i, key in enumerate(order)}
        left = np.full(len(order), -1, np.int64)
        right = np.full(len(order), -1, np.int64)
        for i, (d, j) in enumerate(order):
            if splits[d][j]:
                left[i] = pre[(d + 1, 2 * ranks[d][j])]
                right[i] = pre[(d + 1, 2 * ranks[d][j] + 1)]
        offs = np.cumsum([0] + [len(s) for s in splits])
        idx = torch.from_numpy(np.asarray([offs[d] + j for d, j in order],
                                          np.int64)).to(self.device)
        value, feature, threshold = (torch.cat([lv[k] for lv in levels])[idx]
                                     for k in (0, 2, 3))
        self._arrays = (feature, threshold, torch.from_numpy(left).to(idx),
                        torch.from_numpy(right).to(idx), value,
                        torch.from_numpy(left < 0).to(self.device))
        self._nodes = None
        self.depth = len(levels) - 1

    # ---- predict ------------------------------------------------------------
    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """Vectorized prediction of ``x`` ``[n, d]`` (f64, on the tree's
        device): all rows descend in lockstep."""
        feature, threshold, left, right, value, is_leaf = self.arrays
        cur = walk(feature.clamp(min=0)[None], threshold[None], left[None],
                   right[None], is_leaf[None], x, self.depth)
        return value[cur[0]]

    def predict_reference(self, x) -> np.ndarray:
        """Scalar per-sample tree walk — the parity oracle for ``predict``."""
        x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                       np.float64)
        nodes = self.nodes
        out = np.zeros(x.shape[0])
        for i in range(x.shape[0]):
            node = nodes[0]
            while not node.is_leaf:
                node = nodes[node.left
                             if x[i, node.feature] <= node.threshold
                             else node.right]
            out[i] = node.value
        return out
