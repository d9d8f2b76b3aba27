"""Device milliseconds a step of the forward: the self time of the port's
``train.forward`` span (the model and the loss) and of every op's
``*.fwd`` span inside it, in profiled steps of the cell (``spans.py``)."""

from gnnbench import spans


def read(ctx):
    return spans.summed_ms(ctx, "forward", ".fwd")
