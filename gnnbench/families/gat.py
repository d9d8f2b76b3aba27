"""The port's GAT (``models.GAT``) and its hidden layer's attention op."""

from __future__ import annotations

import torch

from custom_op_benchmark_tpu_torch.models import GAT
from custom_op_benchmark_tpu_torch.ops.ell import ell_gat_attention
from gnnbench.reference import gat as plain


def build(model: dict, device) -> torch.nn.Module:
    return GAT(hidden_dim=model["hidden_dim"], out_dim=model["out_dim"],
               num_layers=model["num_layers"], num_heads=model["num_heads"],
               in_dim=model["in_dim"], device=device)


def mp_probe(model: dict, views: dict, n: int, e: int, seed: int, device):
    """``(fn, operations, bytes)``: the forward and backward of
    ``ell_gat_attention`` on the cell's ELL view at a hidden layer's shape
    (z of (n, heads, hidden)); None off the ELL view."""
    if "ell" not in views:
        return None
    src_ell, dst_ell = views["ell"]
    h, d = model["num_heads"], model["hidden_dim"]
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    z = torch.randn(n, h, d, generator=gen, device=device,
                    requires_grad=True)
    a_l, a_r = (torch.randn(h, d, generator=gen, device=device)
                .div_(d ** 0.5).requires_grad_() for _ in range(2))
    dy = torch.randn(n, h, d, generator=gen, device=device)

    def fn():
        out = ell_gat_attention(dst_ell, src_ell, a_l, a_r, z)
        return torch.autograd.grad(out, (z, a_l, a_r), dy)

    flops, nbytes = plain.mp_counts(n, e, h, d)
    return fn, flops, nbytes
