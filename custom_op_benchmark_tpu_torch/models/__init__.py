"""Models: the graph transformer, GAT, GCN and GraphSAGE."""

from custom_op_benchmark_tpu_torch.models.convert import flax_to_state_dict
from custom_op_benchmark_tpu_torch.models.gat import GAT, GATLayer
from custom_op_benchmark_tpu_torch.models.gcn import GCN, GCNLayer
from custom_op_benchmark_tpu_torch.models.sage import GraphSAGE, SAGELayer
from custom_op_benchmark_tpu_torch.models.transformer import (
    GraphMultiHeadAttention,
    GraphTransformer,
    GraphTransformerLayer,
)

__all__ = ["GAT", "GATLayer", "GCN", "GCNLayer", "GraphMultiHeadAttention",
           "GraphSAGE", "GraphTransformer", "GraphTransformerLayer",
           "SAGELayer", "flax_to_state_dict"]
