"""How far the mesh's node streams overlap on the device in the traced
slice: the summed time of its operations over their union (1: the nodes
never ran at once)."""
from bench.profile import busy_seconds, summed_seconds


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    return summed_seconds(t.device) / busy_seconds(t.device)
