"""The RevGAT cell's device milliseconds a step of the backward
(``train.backward``'s self time and every ``*.bwd`` span, the blocks'
``train.reversible.bwd`` among them; the recompute inside it is in spans
of its own), as ``backward_device_ms`` reads them."""

from gnnbench.metrics.backward_device_ms import read  # noqa: F401
