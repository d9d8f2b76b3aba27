"""Dataclass configurations (counterpart of custom_op_benchmark_tpu/utils/
config.py): the same fields and defaults. ``ModelConfig.build`` takes the
input width, which the port's modules need at construction (flax infers
it at the first call)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class GraphConfig:
    """The benchmark graph; the defaults are the reference workload (512
    disjoint 30-cliques)."""

    kind: str = "clique_batch"       # clique_batch | random | power_law
    batch_size: int = 512
    length: int = 30
    n_nodes: Optional[int] = None    # for random graphs
    n_edges: Optional[int] = None
    seed: int = 0

    def build(self, **kw):
        from custom_op_benchmark_tpu_torch.graph import (
            clique_batch,
            random_graph,
        )

        if self.kind == "clique_batch":
            return clique_batch(self.batch_size, self.length, **kw)
        if self.kind in ("random", "power_law"):
            return random_graph(self.n_nodes, self.n_edges, seed=self.seed,
                                power_law=self.kind == "power_law", **kw)
        raise ValueError(f"unknown graph kind {self.kind!r}")


@dataclasses.dataclass
class ModelConfig:
    arch: str = "gat"                # gat | gcn | gin | sage | transformer
    hidden_dim: int = 64
    out_dim: int = 7
    num_layers: int = 2
    num_heads: int = 8
    dropout_rate: float = 0.0

    def build(self, *, in_dim: int, **kw):
        from custom_op_benchmark_tpu_torch import models as m

        if self.arch == "gat":
            return m.GAT(self.hidden_dim, self.out_dim, self.num_layers,
                         self.num_heads, self.dropout_rate, in_dim=in_dim,
                         **kw)
        if self.arch == "gcn":
            return m.GCN(self.hidden_dim, self.out_dim, self.num_layers,
                         self.dropout_rate, in_dim=in_dim, **kw)
        if self.arch == "gin":
            return m.GIN(self.hidden_dim, self.out_dim, self.num_layers,
                         in_dim=in_dim, **kw)
        if self.arch == "sage":
            return m.GraphSAGE(self.hidden_dim, self.out_dim,
                               self.num_layers, self.dropout_rate,
                               in_dim=in_dim, **kw)
        if self.arch == "transformer":
            return m.GraphTransformer(
                dim=self.hidden_dim, num_heads=self.num_heads,
                num_layers=self.num_layers, out_dim=self.out_dim,
                dropout_rate=self.dropout_rate, in_dim=in_dim, **kw)
        raise ValueError(f"unknown arch {self.arch!r}")


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 100
    learning_rate: float = 1e-2
    weight_decay: float = 5e-4
    batch_size: int = 1024           # sampled training only
    fanouts: Tuple[int, ...] = (25, 10)
    seed: int = 0


@dataclasses.dataclass
class BenchConfig:
    warmup: int = 3
    iters: int = 10
    dim: int = 1024                  # single-head suite
    heads: int = 8                   # multi-head suite
    head_dim: int = 64
    dtype: str = "float32"
