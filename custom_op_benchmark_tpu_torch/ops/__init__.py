"""The op family: the public API (segment oracle and strategy dispatch),
the ops on the block-sparse tile view and on the degree-bucketed ELL
layout, with hand VJPs over the CUDA kernels, and the ops on the
component-batched dense layout."""

from custom_op_benchmark_tpu_torch.ops.dense_block import (
    block_attention,
    block_copy_spmm,
    block_gat_attention,
    block_node_mul_edge,
    block_sddmm,
    block_softmax,
    block_spmm,
)
from custom_op_benchmark_tpu_torch.ops.ell import (
    PackedEdgeWeights,
    ell_attention,
    ell_combine_rows,
    ell_copy_spmm,
    ell_cross_packed,
    ell_dual,
    ell_edge_bias_attention,
    ell_gat_attention,
    ell_gather_edges,
    ell_node_mul_edge,
    ell_pack_weights,
    ell_scatter_edges,
    ell_sddmm,
    ell_softmax,
    ell_spmm,
    ell_unpack_weights,
)
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

__all__ = ["PackedEdgeWeights", "attention", "block_attention",
           "block_copy_spmm", "block_gat_attention", "block_node_mul_edge",
           "block_sddmm", "block_softmax", "block_spmm", "edge_softmax",
           "ell_attention", "ell_combine_rows", "ell_copy_spmm",
           "ell_cross_packed", "ell_dual", "ell_edge_bias_attention",
           "ell_gat_attention", "ell_gather_edges", "ell_node_mul_edge",
           "ell_pack_weights", "ell_scatter_edges", "ell_sddmm",
           "ell_softmax", "ell_spmm", "ell_unpack_weights", "gat_attention",
           "gsddmm", "gspmm", "node_mul_edge", "sddmm",
           "softmax_aggregate_dst", "tiled_attention", "tiled_sddmm",
           "tiled_softmax", "tiled_spmm", "vector_spmm"]
