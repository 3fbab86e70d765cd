"""Execution runtime of the port: the Session API over the local
executor, plus weight set-up and the unpartitioned reference."""
from .engine import (ExecStats, init_weights, run_reference,
                     weights_from_numpy)
from .session import ExecConfig, Session

__all__ = [
    "ExecConfig", "Session", "ExecStats", "init_weights",
    "weights_from_numpy", "run_reference",
]
