"""The table of peaks and the arithmetic of a roofline bound.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit). The model families count their own operations and bytes
(``reference/<family>.py``) with the rules below, from the graph's sizes
and the widths only, so a count reads the same work whatever implements
it:

- a dense product of (m, k) by (k, n) is 2·m·k·n operations;
- a bound counts each input byte read once and each output byte written
  once;
- a training step is its forward and a backward counted as twice the
  forward; recomputation and the optimizer are not counted.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12        # float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12      # bf16 on the tensor cores, dense
PEAK_HBM_BYTES = 3.35e12      # HBM3, bytes/s
F32 = 4
INDEX = 4                     # int32 index


def dense(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def bound_s(flops: float, nbytes: float) -> tuple:
    """(seconds, what sets it) of the least time the card could take:
    the larger of operations at the f32 peak and bytes at the HBM peak."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def step_flops(forward: float) -> float:
    """A training step's operations from its forward's."""
    return 3.0 * forward
