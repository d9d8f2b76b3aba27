"""The 95th percentile of every window step's time: the gaps between the
CUDA events recorded after consecutive steps, the first from an event at
the window's start."""

import numpy as np


def read(ctx):
    if not ctx.step_s:
        return None
    return float(np.percentile(np.asarray(ctx.step_s) * 1e3, 95))
