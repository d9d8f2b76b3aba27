"""The RevGAT cell's device milliseconds a step of the ``train.optimizer``
span (AdamW's step over its 2,098,256 parameters), as
``optimizer_device_ms`` reads them."""

from gnnbench.metrics.optimizer_device_ms import read  # noqa: F401
