"""Distributed plans over a mesh of shards: the gather plan, the halo plan,
head parallelism and edge-partitioned training.

Counterpart of custom_op_benchmark_tpu/parallel/. A mesh holds its P
shards either in one process on one device (the local backend: the whole
plan on one card) or one shard a process over ``torch.distributed`` (the
process backend: NCCL on cards, gloo on the CPU); see parallel/mesh.py.
"""

from custom_op_benchmark_tpu_torch.parallel.mesh import (
    Mesh,
    global_sum,
    make_mesh,
    psum_grads,
    shard,
    shard_rows,
)
from custom_op_benchmark_tpu_torch.parallel.halo import (
    HaloEll,
    HaloGraph,
    HaloPackedWeights,
    halo_attention_ell,
    halo_edge_data,
    halo_ell,
    halo_gat_attention,
    halo_graph,
    halo_pack_weights,
    halo_spmm,
    halo_spmm_ell,
    shard_halo_nodes,
)
from custom_op_benchmark_tpu_torch.parallel.shard_ops import (
    DistGraph,
    dist_edge_softmax,
    dist_gat_attention,
    dist_graph,
    dist_sddmm,
    dist_vector_spmm,
)
from custom_op_benchmark_tpu_torch.parallel.tp import (
    head_sharding,
    shard_heads,
    tp_attention,
    tp_gat_attention,
    tp_transformer_block,
)
from custom_op_benchmark_tpu_torch.parallel.train_dist import (
    dist_gat_forward,
    dist_params_from_jax,
    dist_transformer_forward,
    fit_edge_partitioned,
    init_dist_gat,
    init_dist_transformer,
)

__all__ = ["DistGraph", "HaloEll", "HaloGraph", "HaloPackedWeights", "Mesh",
           "dist_edge_softmax", "dist_gat_attention", "dist_gat_forward",
           "dist_graph", "dist_params_from_jax", "dist_sddmm",
           "dist_transformer_forward", "dist_vector_spmm",
           "fit_edge_partitioned", "global_sum", "halo_attention_ell", "halo_edge_data",
           "halo_ell", "halo_gat_attention", "halo_graph",
           "halo_pack_weights", "halo_spmm", "halo_spmm_ell",
           "head_sharding", "init_dist_gat", "init_dist_transformer",
           "make_mesh", "psum_grads", "shard", "shard_halo_nodes", "shard_heads",
           "shard_rows", "tp_attention", "tp_gat_attention",
           "tp_transformer_block"]
