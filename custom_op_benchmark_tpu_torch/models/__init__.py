"""Models: the graph transformer, GAT (and DGL's ogbn-arxiv GAT, and
RevGAT), GCN, GIN and GraphSAGE."""

from custom_op_benchmark_tpu_torch.models.convert import flax_to_state_dict
from custom_op_benchmark_tpu_torch.models.gat import GAT, GATLayer
from custom_op_benchmark_tpu_torch.models.gat_dgl import GATDGL, GATDGLLayer
from custom_op_benchmark_tpu_torch.models.gcn import GCN, GCNLayer
from custom_op_benchmark_tpu_torch.models.gin import GIN, GINLayer
from custom_op_benchmark_tpu_torch.models.revgat import RevGAT
from custom_op_benchmark_tpu_torch.models.sage import GraphSAGE, SAGELayer
from custom_op_benchmark_tpu_torch.models.transformer import (
    GraphMultiHeadAttention,
    GraphTransformer,
    GraphTransformerLayer,
)

__all__ = ["GAT", "GATDGL", "GATDGLLayer", "GATLayer", "GCN", "GCNLayer",
           "GIN", "GINLayer", "GraphMultiHeadAttention",
           "GraphSAGE", "GraphTransformer", "GraphTransformerLayer",
           "RevGAT", "SAGELayer", "flax_to_state_dict"]
