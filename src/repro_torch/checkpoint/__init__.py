"""Pytree checkpoints (the port of the JAX package's ``checkpoint/``)."""
from .ckpt import load_pytree, save_pytree

__all__ = ["save_pytree", "load_pytree"]
