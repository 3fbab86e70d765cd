"""Device busy time of the traced slice (the union of its operations'
intervals) over the decode steps in it."""
from bench.profile import busy_seconds


def read(run):
    t = run.trace
    if t is None or not t.device or not run.tracer.steps:
        return None
    return 1e3 * busy_seconds(t.device) / len(run.tracer.steps)
