"""Host milliseconds to sample one batch, the median over the window's
batches (timed around the port's sampler calls)."""

import statistics


def read(ctx):
    sample_s = ctx.counts.get("sample_s")
    if not sample_s:
        return None
    return 1e3 * statistics.median(sample_s)
