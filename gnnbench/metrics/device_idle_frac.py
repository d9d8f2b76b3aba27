"""1 − (device busy seconds a step on the profiled tail) ÷ (the mean
unprofiled step of the window), at least 0."""

import statistics


def read(ctx):
    if ctx.busy_per_step is None or not ctx.step_s:
        return None
    return max(0.0, 1.0 - ctx.busy_per_step / statistics.fmean(ctx.step_s))
