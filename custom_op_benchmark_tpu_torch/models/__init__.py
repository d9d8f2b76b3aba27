"""Models; so far the graph transformer on the tile path."""

from custom_op_benchmark_tpu_torch.models.convert import flax_to_state_dict
from custom_op_benchmark_tpu_torch.models.transformer import (
    GraphMultiHeadAttention,
    GraphTransformer,
    GraphTransformerLayer,
)

__all__ = ["GraphMultiHeadAttention", "GraphTransformer",
           "GraphTransformerLayer", "flax_to_state_dict"]
