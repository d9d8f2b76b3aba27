"""The DGL ogbn-arxiv GAT cell's device milliseconds a step of the
backward (``train.backward``'s self time and every ``*.bwd`` span), as
``backward_device_ms`` reads them."""

from gnnbench.metrics.backward_device_ms import read  # noqa: F401
