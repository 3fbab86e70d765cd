"""The optimizer and learning-rate schedule of the LM training path (the
port of the JAX package's ``optim/``)."""
from .adamw import adamw_init, adamw_update
from .schedule import cosine_schedule

__all__ = ["adamw_init", "adamw_update", "cosine_schedule"]
