"""``ops.ell.ell_gat_attention``'s forward and backward at the GAT's hidden
layer (z of (nodes, heads, hidden)) on the cell's ELL view: its bound
(the larger of its bytes at 3.35 TB/s and its operations at 67 TFLOP/s,
by the reference family's count, ``reference/gat.mp_counts``) over its
time by ``timing.bench_fn``, in percent."""

from gnnbench import counts, timing


def read(ctx):
    if not ctx.on_card:
        return None
    probe = ctx.probe()
    if probe is None:
        return None
    fn, flops, nbytes = probe
    return 100.0 * counts.bound_s(flops, nbytes)[0] / timing.bench_fn(fn)
