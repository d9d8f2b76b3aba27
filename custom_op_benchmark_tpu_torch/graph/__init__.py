"""Graph containers and builders (host-side numpy, torch tensors)."""

from custom_op_benchmark_tpu_torch.graph.blockdiag import (
    BlockGraph,
    block_graph,
)
from custom_op_benchmark_tpu_torch.graph.builders import (
    clique_batch,
    grid_graph,
    random_graph,
)
from custom_op_benchmark_tpu_torch.graph.ell import (
    DEFAULT_WIDTHS,
    TRAIN_WIDTHS,
    EllBucket,
    EllGraph,
    ell_pack,
)
from custom_op_benchmark_tpu_torch.graph.graph import Graph, from_coo
from custom_op_benchmark_tpu_torch.graph.reorder import (
    Reordering,
    connected_components,
    degree_balanced_order,
    reorder_graph,
    tile_aligned_order,
)
from custom_op_benchmark_tpu_torch.graph.tiled import TiledGraph, tile_graph

__all__ = ["BlockGraph", "DEFAULT_WIDTHS", "EllBucket", "EllGraph", "Graph",
           "Reordering", "TRAIN_WIDTHS", "TiledGraph", "block_graph",
           "clique_batch",
           "connected_components", "degree_balanced_order", "ell_pack",
           "from_coo", "grid_graph", "random_graph", "reorder_graph",
           "tile_aligned_order", "tile_graph"]
