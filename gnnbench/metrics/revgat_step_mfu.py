"""RevGAT's operations a step (``reference/revgat``'s count, from the graph
and the widths; backward twice the forward; the recompute not counted)
over the mean unprofiled step at the f32 peak of 67 TFLOP/s, in percent:
the whole step's share of its peak, as ``step_mfu`` reads it."""

from gnnbench.metrics.step_mfu import read  # noqa: F401
