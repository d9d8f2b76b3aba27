"""The op family: the public API (segment oracle and strategy dispatch)
and the ops on the block-sparse tile view, with hand VJPs over the CUDA
kernels."""

from custom_op_benchmark_tpu_torch.ops.primitives import (
    attention,
    edge_softmax,
    gat_attention,
    gsddmm,
    gspmm,
    node_mul_edge,
    sddmm,
    softmax_aggregate_dst,
    vector_spmm,
)
from custom_op_benchmark_tpu_torch.ops.tiled import (
    tiled_attention,
    tiled_sddmm,
    tiled_softmax,
    tiled_spmm,
)

__all__ = ["attention", "edge_softmax", "gat_attention", "gsddmm", "gspmm",
           "node_mul_edge", "sddmm", "softmax_aggregate_dst",
           "tiled_attention", "tiled_sddmm", "tiled_softmax", "tiled_spmm",
           "vector_spmm"]
