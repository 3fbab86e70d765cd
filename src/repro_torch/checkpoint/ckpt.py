"""Minimal pytree checkpointing: flattened key-paths -> one .npz file (the
port of the JAX package's ``checkpoint/ckpt.py``).

A tree is nested dicts and lists (or tuples) whose leaves are tensors or
numpy arrays.  Keys are the reference's: the path's dict keys and list
indices joined by ``/``, dict keys in sorted order as JAX flattens them,
and bfloat16 leaves saved as float32, so a file written by either package
loads in the other.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Iterator, Tuple

import numpy as np
import torch


def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[
        Tuple[str, Any]]:
    """(``/``-joined key path, leaf) in JAX's flattening order; ``None``
    and empty containers have no leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif tree is not None:
        yield "/".join(path), tree


def _map(tree: Any, fn: Callable[[str, Any], Any],
         path: Tuple[str, ...] = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, path + (str(i),))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn("/".join(path), tree)


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:   # no numpy dtype
            t = t.float()
        return t.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "biufc":   # e.g. ml_dtypes bfloat16
        arr = arr.astype(np.float32)
    return arr


def save_pytree(tree: Any, path: str) -> None:
    """Write every leaf of ``tree`` to the compressed ``.npz`` at ``path``
    under its key path."""
    flat = {key: _to_numpy(leaf) for key, leaf in _leaves(tree)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **flat)


def load_pytree(template: Any, path: str) -> Any:
    """A tree shaped as ``template`` with each leaf read from ``path``, cast
    to the template leaf's dtype (and, for a tensor, put on its device).
    Raises ``KeyError`` for a missing key and ``ValueError`` for a shape
    that differs."""
    with np.load(path) as data:
        def read(key: str, leaf: Any):
            if key not in data:
                raise KeyError(f"checkpoint missing {key}")
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {tuple(leaf.shape)}")
            if isinstance(leaf, torch.Tensor):
                return torch.from_numpy(np.array(arr)).to(
                    dtype=leaf.dtype, device=leaf.device)
            return np.asarray(arr).astype(leaf.dtype)
        return _map(template, read)
