"""Device milliseconds a step of the backward: the self time of the port's
``train.backward`` span and of every op's ``*.bwd`` span (on autograd's
thread), in profiled steps of the cell (``spans.py``)."""

from gnnbench import spans


def read(ctx):
    return spans.summed_ms(ctx, "backward", ".bwd")
