"""Graph containers and builders (host-side numpy, torch tensors)."""

from custom_op_benchmark_tpu_torch.graph.builders import (
    clique_batch,
    grid_graph,
    random_graph,
)
from custom_op_benchmark_tpu_torch.graph.graph import Graph, from_coo
from custom_op_benchmark_tpu_torch.graph.tiled import TiledGraph, tile_graph

__all__ = ["Graph", "TiledGraph", "clique_batch", "from_coo", "grid_graph",
           "random_graph", "tile_graph"]
