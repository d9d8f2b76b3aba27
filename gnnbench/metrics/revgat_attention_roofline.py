"""``ops.ell.ell_gat_attention`` with no dst term (no ``a_r``), forward and
backward, at a RevGAT block group's shape (z of (nodes, 3 heads, 128)), on
the cell's ELL view: its bound (the larger of its bytes at 3.35 TB/s and
its operations at 67 TFLOP/s, by ``reference/gat_dgl.mp_counts``) over its
time by ``timing.bench_fn``, in percent. The probe is the family's
(``families/revgat.mp_probe``); the reading is
``ell_gat_attention_roofline``'s."""

from gnnbench.metrics.ell_gat_attention_roofline import read  # noqa: F401
