"""Device milliseconds a step that the reversible blocks' backward spends
recomputing their functions: the self time of the port's
``train.recompute`` span and of every span opened inside it, whose names
end in ``.recompute`` (``ell.gat_attention.fwd.recompute``), in profiled
steps of the cell (``spans.py``)."""

from gnnbench import spans


def read(ctx):
    return spans.summed_ms(ctx, "recompute", ".recompute")
