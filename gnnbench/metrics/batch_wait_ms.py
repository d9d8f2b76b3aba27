"""Milliseconds a step that the training thread waited for the next
prefetched batch, the mean over the window's steps."""

import statistics


def read(ctx):
    wait_s = ctx.counts.get("wait_s")
    if not wait_s:
        return None
    return 1e3 * statistics.fmean(wait_s)
