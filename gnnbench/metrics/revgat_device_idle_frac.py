"""The RevGAT cell's device idle share: 1 − (device busy seconds a step on
the profiled tail) ÷ (the mean unprofiled step of the window), as
``device_idle_frac`` reads it."""

from gnnbench.metrics.device_idle_frac import read  # noqa: F401
