"""The model's operations a step (the reference family's count, from the
graph and the widths) over the mean unprofiled step at the f32 peak of
67 TFLOP/s, in percent."""

import statistics

from gnnbench import counts


def read(ctx):
    if not ctx.on_card or not ctx.step_s or not ctx.counts["flops"]:
        return None
    step = statistics.fmean(ctx.step_s)
    return 100.0 * ctx.counts["flops"] / (step * counts.PEAK_F32_FLOPS)
