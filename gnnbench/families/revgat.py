"""The port's RevGAT (``models.RevGAT``) and its blocks' attention op, the
DGL layer's with no dst term, at a group's shape."""

from __future__ import annotations

import torch

from custom_op_benchmark_tpu_torch.models import RevGAT
from gnnbench.families import gat_dgl


def build(model: dict, device) -> torch.nn.Module:
    return RevGAT(hidden_dim=model["hidden_dim"], out_dim=model["out_dim"],
                  num_layers=model["num_layers"],
                  num_heads=model["num_heads"], group=model["group"],
                  in_dim=model["in_dim"], device=device)


def mp_probe(model: dict, views: dict, n: int, e: int, seed: int, device):
    """``(fn, operations, bytes)``: the forward and backward of
    ``ell_gat_attention`` with no ``a_r`` on the cell's ELL view at a
    block group's shape (z of (n, heads, hidden / group)), as
    ``families/gat_dgl.mp_probe`` sets it up; None off the ELL view."""
    group_shape = dict(model, hidden_dim=model["hidden_dim"] // model["group"])
    return gat_dgl.mp_probe(group_shape, views, n, e, seed, device)
