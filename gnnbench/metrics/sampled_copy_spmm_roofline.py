"""``ops.sampled.sampled_copy_spmm``'s forward and backward (the mean
aggregation) at GraphSAGE's hidden width on the first checked sampled
batch: its bound (the larger of its bytes at 3.35 TB/s and its operations
at 67 TFLOP/s, by ``reference/sage.mp_counts`` over the batch's real nodes
and edges) over its time by ``timing.bench_fn``, in percent."""

from gnnbench.metrics.ell_gat_attention_roofline import read  # noqa: F401
