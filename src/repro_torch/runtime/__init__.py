"""Execution runtime of the port: the Session API over the local and the
mesh executor, weight set-up and the unpartitioned reference, and the
decode slice (:class:`DecodeSession` over the distributed paged KV cache,
:class:`TransformerSpec` and the decode-graph helpers)."""
from .engine import (EXECUTORS, ExecStats, MeasuredOccupancy, init_weights,
                     run_reference, weights_from_numpy)
from .session import ExecConfig, Session
from .kv_cache import PagedKVCache
from .decode import (DecodeSession, TransformerSpec, decode_graph,
                     greedy_decode, init_transformer, plan_decode,
                     prefill_graph, reference_decode,
                     transformer_weights_from_numpy)

__all__ = [
    "EXECUTORS", "ExecConfig", "Session", "ExecStats", "MeasuredOccupancy",
    "init_weights",
    "weights_from_numpy", "run_reference", "PagedKVCache", "DecodeSession",
    "TransformerSpec", "decode_graph", "prefill_graph", "init_transformer",
    "transformer_weights_from_numpy", "reference_decode", "greedy_decode",
    "plan_decode",
]
