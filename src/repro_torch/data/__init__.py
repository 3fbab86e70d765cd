"""The synthetic LM data pipeline (the port of the JAX package's
``data/``)."""
from .pipeline import SyntheticLMDataset, make_batch_specs

__all__ = ["SyntheticLMDataset", "make_batch_specs"]
