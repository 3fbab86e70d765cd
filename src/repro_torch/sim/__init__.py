"""Edge-testbed simulator: the stand-in for the paper's SRIO DSP cluster
(the port of the JAX package's ``repro.sim``)."""
from .trace import (HETERO_PRESETS, TraceConfig, generate_i_traces,
                    generate_s_traces, hetero_trace_config, train_estimators)

__all__ = ["HETERO_PRESETS", "TraceConfig", "generate_i_traces",
           "generate_s_traces", "hetero_trace_config", "train_estimators"]
