"""The RevGAT cell's device milliseconds a step of the forward
(``train.forward``'s self time and every ``*.fwd`` span inside it, the
blocks' ``train.reversible.fwd`` among them), as ``forward_device_ms``
reads them."""

from gnnbench.metrics.forward_device_ms import read  # noqa: F401
