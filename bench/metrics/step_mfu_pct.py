"""The model's operations for the window's tokens (``bench.counts``:
projections, MLP, logits where the entry point computes them, attention
at each token's live keys) over the window's time at the configuration's
dtype's peak."""
from bench import counts


def read(run):
    peak = counts.PEAK_FLOPS[run.cell.config["dtype"]]
    return 100.0 * run.driver.window_flops(run.served) / run.window_s / peak
