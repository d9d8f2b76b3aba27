"""Ops on the block-sparse tile view, with hand VJPs over the CUDA kernels."""

from custom_op_benchmark_tpu_torch.ops.tiled import (
    tiled_attention,
    tiled_sddmm,
    tiled_softmax,
    tiled_spmm,
)

__all__ = ["tiled_attention", "tiled_sddmm", "tiled_softmax", "tiled_spmm"]
