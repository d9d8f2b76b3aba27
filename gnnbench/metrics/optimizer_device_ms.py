"""Device milliseconds a step of the port's ``train.optimizer`` span
(AdamW's step), in profiled steps of the cell (``spans.py``)."""

from gnnbench import spans


def read(ctx):
    return spans.summed_ms(ctx, "optimizer", "")
