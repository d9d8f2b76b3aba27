"""The DGL ogbn-arxiv GAT's operations a step (``reference/gat_dgl``'s
count, from the graph and the widths; backward twice the forward) over
the mean unprofiled step at the f32 peak of 67 TFLOP/s, in percent: the
whole step's share of its peak, as ``step_mfu`` reads it."""

from gnnbench.metrics.step_mfu import read  # noqa: F401
