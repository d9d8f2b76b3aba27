"""Datasets: synthetic node-classification fixtures."""

from custom_op_benchmark_tpu_torch.data.synthetic import (
    NodeClassificationDataset,
    arxiv_like,
    cora_like,
    planted_partition,
)

__all__ = ["NodeClassificationDataset", "arxiv_like", "cora_like",
           "planted_partition"]
