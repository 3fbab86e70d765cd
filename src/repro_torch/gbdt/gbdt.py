"""Gradient-boosted decision trees (squared error) on tensors.

The port of the JAX package's ``repro/gbdt/gbdt.py``.  Data, gradients,
the node arrays and the packed forest live on the regressor's device (the
card unless the caller passes ``device="cpu"``); the bin edges and the
subsample draws come from the host, computed exactly as the reference
computes them (``np.quantile`` + ``np.unique``; one
``np.random.default_rng(seed)`` stream), so a fit on CPU tensors gives the
reference's forest bit for bit (see ``tree.py`` for the order of sums).

Inference stacks every tree's flat node arrays into padded ``(T, M)``
matrices and advances all trees over all samples in lockstep.  Trees are
added in fit order, ``out += lr * leaf`` as two roundings per tree — a
fused multiply-add would round differently — so ``predict`` equals
``predict_reference`` (the per-tree scalar walk) bit for bit.

The forest reads and writes the reference's npz layout (:meth:`save`,
:meth:`load`) and takes its node arrays (:meth:`from_arrays`).
``fit(verbose_every=...)`` logs ``gbdt.fit`` lines through
``repro_torch.obs.log`` (``REPRO_LOG``), the RMSEs computed on the host as
the reference computes them.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .tree import FlatTree, RegressionTree, walk


class GBDTRegressor:
    def __init__(self, n_estimators: int = 120, learning_rate: float = 0.15,
                 max_depth: int = 6, min_child_weight: float = 2.0,
                 reg_lambda: float = 1.0, n_bins: int = 64,
                 subsample: float = 0.9, seed: int = 0, device="cuda"):
        self.n_estimators = n_estimators
        self.learning_rate = learning_rate
        self.max_depth = max_depth
        self.min_child_weight = min_child_weight
        self.reg_lambda = reg_lambda
        self.n_bins = n_bins
        self.subsample = subsample
        self.seed = seed
        self.device = torch.device(device)
        self.base_: float = 0.0
        self.n_features_: Optional[int] = None
        self.trees_: List[RegressionTree] = []
        self._forest: Optional[Tuple] = None

    # ---- binning ----------------------------------------------------------
    def _make_bins(self, x: np.ndarray) -> List[np.ndarray]:
        edges = []
        qs = np.linspace(0, 1, self.n_bins + 1)[1:-1]
        for f in range(x.shape[1]):
            e = np.unique(np.quantile(x[:, f], qs))
            edges.append(e)
        return edges

    @staticmethod
    def _bin(x: torch.Tensor, edges: List[np.ndarray]) -> torch.Tensor:
        """``np.searchsorted(e, x, side="left")`` per feature, on the
        device (exact: equal f64 edges and values)."""
        out = torch.empty(x.shape, dtype=torch.int64, device=x.device)
        for f, e in enumerate(edges):
            et = torch.from_numpy(np.ascontiguousarray(e, np.float64)
                                  ).to(x.device)
            out[:, f] = torch.searchsorted(et, x[:, f].contiguous(),
                                           side="left")
        return out

    def _host(self, a) -> np.ndarray:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        return np.asarray(a, dtype=np.float64)

    # ---- fit / predict ----------------------------------------------------
    def fit(self, x, y, eval_set=None,
            verbose_every: int = 0) -> "GBDTRegressor":
        x = self._host(x)
        y = self._host(y)
        dev = self.device
        rng = np.random.default_rng(self.seed)
        self.n_features_ = int(x.shape[1])
        edges = self._make_bins(x)
        xd = torch.from_numpy(x).to(dev)
        yd = torch.from_numpy(y).to(dev)
        binned = self._bin(xd, edges)
        self.base_ = float(y.mean())
        pred = torch.full_like(yd, self.base_)
        self.trees_ = []
        self._forest = None
        hess = torch.ones_like(yd)
        for t in range(self.n_estimators):
            grad = pred - yd
            tree = RegressionTree(self.max_depth, self.min_child_weight,
                                  self.reg_lambda, device=dev)
            if self.subsample < 1.0:
                m = torch.from_numpy(rng.random(len(y)) < self.subsample
                                     ).to(dev)
                tree.fit(binned[m], edges, grad[m], hess[m])
            else:
                tree.fit(binned, edges, grad, hess)
            upd = tree.predict(xd)
            pred += self.learning_rate * upd
            self.trees_.append(tree)
            if verbose_every and (t + 1) % verbose_every == 0:
                from repro_torch.obs.log import log
                p = pred.cpu().numpy()
                fields = {"tree": t + 1,
                          "train_rmse": float(np.sqrt(np.mean((p - y)**2)))}
                if eval_set is not None:
                    ex, ey = eval_set
                    ep = self._host(self.predict(ex))
                    fields["eval_rmse"] = float(
                        np.sqrt(np.mean((ep - self._host(ey))**2)))
                log("gbdt.fit", **fields)
        return self

    # ---- batched forest inference -----------------------------------------
    def _packed_forest(self) -> Tuple:
        """Every tree's arrays padded into ``(T, M)`` device matrices
        (cached).  Padding slots are leaves pointing at themselves with
        value 0, so a finished tree idles while deeper trees descend."""
        if self._forest is not None and \
                self._forest[0].shape[0] == len(self.trees_):
            return self._forest
        dev = self.device
        T = len(self.trees_)
        M = max(len(tr.arrays[0]) for tr in self.trees_)
        feature = torch.zeros((T, M), dtype=torch.int64, device=dev)
        threshold = torch.zeros((T, M), dtype=torch.float64, device=dev)
        left = torch.zeros((T, M), dtype=torch.int64, device=dev)
        right = torch.zeros((T, M), dtype=torch.int64, device=dev)
        value = torch.zeros((T, M), dtype=torch.float64, device=dev)
        is_leaf = torch.ones((T, M), dtype=torch.bool, device=dev)
        for t, tr in enumerate(self.trees_):
            f, thr, lo, r, v, leaf = tr.arrays
            m = len(f)
            feature[t, :m] = f.clamp(min=0)     # leaf sentinel -1 -> 0
            threshold[t, :m] = thr
            left[t, :m] = lo
            right[t, :m] = r
            value[t, :m] = v
            is_leaf[t, :m] = leaf
        depth = max(tr.depth for tr in self.trees_)
        self._forest = (feature, threshold, left, right, value, is_leaf,
                        depth)
        return self._forest

    def predict(self, x):
        """Forest prediction of ``x`` ``[n, d]``: a numpy array in, a numpy
        array out (one copy each way); a tensor in, a tensor on the
        forest's device out."""
        as_tensor = isinstance(x, torch.Tensor)
        xd = (x.to(self.device, torch.float64) if as_tensor else
              torch.from_numpy(np.ascontiguousarray(x, np.float64)
                               ).to(self.device))
        n = xd.shape[0]
        out = torch.full((n,), self.base_, dtype=torch.float64,
                         device=self.device)
        if self.trees_ and n:
            feature, threshold, left, right, value, is_leaf, depth = \
                self._packed_forest()
            cur = walk(feature, threshold, left, right, is_leaf, xd, depth)
            steps = self.learning_rate * value.gather(1, cur)   # (T, n)
            # per tree in fit order, the scaled leaf added on its own
            for t in range(len(self.trees_)):
                out += steps[t]
        return out if as_tensor else out.cpu().numpy()

    def predict_reference(self, x) -> np.ndarray:
        """Per-tree scalar-walk prediction on the host — the parity
        oracle."""
        x = self._host(x)
        out = np.full(x.shape[0], self.base_)
        for tree in self.trees_:
            out += self.learning_rate * tree.predict_reference(x)
        return out

    # ---- the reference's node arrays and npz files --------------------------
    @classmethod
    def from_arrays(cls, base: float, lr: float, trees: Sequence[FlatTree],
                    n_features: Optional[int] = None,
                    device="cuda") -> "GBDTRegressor":
        """A fitted forest from the reference's flat node arrays
        (``RegressionTree.flat()`` per tree, numpy)."""
        obj = cls(n_estimators=len(trees), learning_rate=lr, device=device)
        obj.base_ = float(base)
        obj.n_features_ = None if n_features is None else int(n_features)
        obj.trees_ = [RegressionTree.from_flat(t, device=device)
                      for t in trees]
        return obj

    def save(self, path: str) -> None:
        flat = {"base": np.array([self.base_]),
                "lr": np.array([self.learning_rate]),
                "n_trees": np.array([len(self.trees_)]),
                "n_features": np.array([-1 if self.n_features_ is None
                                        else self.n_features_])}
        for i, tr in enumerate(self.trees_):
            f, thr, lo, r, v, leaf = tr.flat()
            flat[f"tree_{i}"] = np.stack(
                [f.astype(np.float64), thr, lo.astype(np.float64),
                 r.astype(np.float64), v, leaf.astype(np.float64)], axis=1)
        np.savez_compressed(path, **flat)

    @classmethod
    def load(cls, path: str, device="cuda") -> "GBDTRegressor":
        data = np.load(path)
        n_features = None
        if "n_features" in data:        # absent in pre-width checkpoints
            nf = int(data["n_features"][0])
            n_features = None if nf < 0 else nf
        trees = []
        for i in range(int(data["n_trees"][0])):
            arr = data[f"tree_{i}"]
            trees.append((arr[:, 0].astype(np.int32), arr[:, 1],
                          arr[:, 2].astype(np.int32),
                          arr[:, 3].astype(np.int32), arr[:, 4],
                          arr[:, 5] > 0.5))
        return cls.from_arrays(float(data["base"][0]), float(data["lr"][0]),
                               trees, n_features, device=device)
