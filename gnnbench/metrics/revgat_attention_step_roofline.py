"""``ops.ell.ell_gat_attention`` with no dst term inside RevGAT's training
step: the bound of the step's attention calls, one a layer C (the larger
of their bytes at 3.35 TB/s and their operations at 67 TFLOP/s, by
``reference/revgat.mp_counts``: the first layer at (heads, hidden), each
block group's at (heads, hidden / group), the last at (1, out)) over the
device time of the spans ``ell.gat_attention.fwd`` and ``.bwd`` a step, in
profiled steps of the cell (``spans.py``), in percent. The recompute's
calls, in spans ending ``.recompute``, are not counted on either side."""

from gnnbench import counts, spans
from gnnbench.reference import revgat as plain


def mp_step_bound_s(model: dict, n: int, e: int) -> float:
    """Seconds of the least time of one step's attention calls."""
    return sum(counts.bound_s(*plain.mp_counts(n, e, h, d))[0]
               for _, h, d in plain.layer_shapes(model))


def read(ctx):
    span_s = spans.per_step(ctx)
    run = spans.path_run(ctx)
    if not span_s or run is None or "ell" not in (
            getattr(run, "views", None) or {}):
        return None
    took = (span_s.get("ell.gat_attention.fwd", 0.0)
            + span_s.get("ell.gat_attention.bwd", 0.0))
    if not took:
        return None
    return 100.0 * mp_step_bound_s(run.model_cfg, run.n, run.e) / took
