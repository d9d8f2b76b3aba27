"""Datasets: synthetic node-classification fixtures, on-disk loaders,
neighbour sampling and the minibatch prefetch pipeline."""

from custom_op_benchmark_tpu_torch.data.datasets import (
    convert_ogb_dir,
    is_ogb_dir,
    load_dataset,
    load_ogb_dir,
)
from custom_op_benchmark_tpu_torch.data.pipeline import prefetch
from custom_op_benchmark_tpu_torch.data.sampling import (
    NeighborSampler,
    SampledBatch,
)
from custom_op_benchmark_tpu_torch.data.synthetic import (
    NodeClassificationDataset,
    arxiv_like,
    cora_like,
    from_numpy_files,
    planted_partition,
)

__all__ = ["NeighborSampler", "NodeClassificationDataset", "SampledBatch",
           "arxiv_like", "convert_ogb_dir", "cora_like", "from_numpy_files",
           "is_ogb_dir", "load_dataset", "load_ogb_dir", "planted_partition",
           "prefetch"]
