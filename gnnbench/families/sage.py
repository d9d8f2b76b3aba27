"""The port's GraphSAGE (``models.GraphSAGE``) and its second layer's
mean aggregation on a sampled batch."""

from __future__ import annotations

import torch

from custom_op_benchmark_tpu_torch.models import GraphSAGE
from custom_op_benchmark_tpu_torch.ops.sampled import sampled_copy_spmm
from gnnbench.reference import sage as plain


def build(model: dict, device) -> torch.nn.Module:
    return GraphSAGE(hidden_dim=model["hidden_dim"],
                     out_dim=model["out_dim"],
                     num_layers=model["num_layers"], in_dim=model["in_dim"],
                     device=device)


def mp_probe(model: dict, views: dict, n: int, e: int, seed: int, device):
    """``(fn, operations, bytes)``: the forward and backward of
    ``sampled_copy_spmm`` on one sampled batch (``views["sampled"] =
    (in_cols, batch graph)``, n real nodes and e real edges) at the hidden
    width; None without a sampled batch."""
    if "sampled" not in views:
        return None
    in_cols, g = views["sampled"]
    d = model["hidden_dim"]
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    x = torch.randn(g.n_nodes, d, generator=gen, device=device,
                    requires_grad=True)
    dy = torch.randn(g.n_nodes, d, generator=gen, device=device)

    def fn():
        out = sampled_copy_spmm(in_cols, g, x, reduce="mean")
        return torch.autograd.grad(out, x, dy)

    flops, nbytes = plain.mp_counts(n, e, d)
    return fn, flops, nbytes
