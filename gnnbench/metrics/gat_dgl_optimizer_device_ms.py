"""The DGL ogbn-arxiv GAT cell's device milliseconds a step of the
``train.optimizer`` span (AdamW's step), as ``optimizer_device_ms`` reads
them."""

from gnnbench.metrics.optimizer_device_ms import read  # noqa: F401
