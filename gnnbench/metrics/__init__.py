"""One reader a metric, found by the metric's name in ``BENCHMARK.json``.

``read(ctx)`` returns the metric's value, or None where the run gives it
nothing to read (the harness then leaves the metric out of the line).
``ctx`` (``run.Context``) holds what the window and the profiled tail
measured and what the path counted.
"""
