"""One reader a metric, found by the metric's name in ``BENCHMARK.json``:
``read(run)`` takes a :class:`bench.harness.Run` and returns the metric's
value, or ``None`` where the run holds nothing to read it from."""
