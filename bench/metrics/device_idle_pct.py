"""The share of the traced slice in which no operation ran on the device:
one less the union of the device's operation intervals over the slice's
wall."""
from bench.profile import busy_seconds


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    return 100.0 * max(0.0, 1.0 - busy_seconds(t.device) / t.wall_s)
