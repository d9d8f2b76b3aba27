"""Graph containers, builders and host-side preprocessing (numpy and the
native graphcore library, torch tensors)."""

from custom_op_benchmark_tpu_torch.graph.blockdiag import (
    BlockGraph,
    block_graph,
)
from custom_op_benchmark_tpu_torch.graph.builders import (
    add_self_loops,
    clique_batch,
    grid_graph,
    random_graph,
    remove_duplicate_edges,
)
from custom_op_benchmark_tpu_torch.graph.cache import cached, graph_key
from custom_op_benchmark_tpu_torch.graph.ell import (
    DEFAULT_WIDTHS,
    TRAIN_WIDTHS,
    EllBucket,
    EllGraph,
    ell_pack,
)
from custom_op_benchmark_tpu_torch.graph.graph import Graph, from_coo
from custom_op_benchmark_tpu_torch.graph.partition import (
    EdgePartition,
    edge_block_rows,
    edge_partition,
    partition_csr,
)
from custom_op_benchmark_tpu_torch.graph.reorder import (
    Reordering,
    connected_components,
    degree_balanced_order,
    reorder_graph,
    tile_aligned_order,
)
from custom_op_benchmark_tpu_torch.graph.tiled import TiledGraph, tile_graph

__all__ = ["BlockGraph", "DEFAULT_WIDTHS", "EdgePartition", "EllBucket",
           "EllGraph", "Graph", "Reordering", "TRAIN_WIDTHS", "TiledGraph",
           "add_self_loops", "block_graph", "cached", "clique_batch",
           "connected_components", "degree_balanced_order",
           "edge_block_rows", "edge_partition", "ell_pack", "from_coo",
           "graph_key", "grid_graph", "partition_csr", "random_graph",
           "remove_duplicate_edges", "reorder_graph", "tile_aligned_order",
           "tile_graph"]
