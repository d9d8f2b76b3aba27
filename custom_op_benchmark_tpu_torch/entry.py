"""The flagship forward step: the code paths behind the power-law headline.

Counterpart of ``entry()`` in the JAX package's ``__graft_entry__.py``: a
power-law graph of 32,768 nodes and 250,000 edges (plus self-loops)
through

- the remat'd bf16 GAT stack on the fused ELL path
  (``ell_gat_attention``: f32 parameters, bf16 activations, f32 logits),
- the fused ELL attention with a packed edge bias
  (``ell_edge_bias_attention`` with ``PackedEdgeWeights``: the reference
  composition MaskedMM + NodeMulEdge + softmax + SpMM in one call), in
  f32 at h = 4, d = 32,

so one call exercises the ELL packing, packed weights, remat and the bf16
policy. Usage::

    from custom_op_benchmark_tpu_torch.entry import entry

    fn, args = entry()                  # on the CUDA device
    logits, attn = fn(*args)

The sizes are keywords whose defaults are the reference's; tests run it
small with ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from custom_op_benchmark_tpu_torch.graph import random_graph
from custom_op_benchmark_tpu_torch.models import GAT
from custom_op_benchmark_tpu_torch.ops import (
    ell_dual,
    ell_edge_bias_attention,
    ell_pack_weights,
)


def entry(*, n_nodes: int = 32768, n_edges: int = 250_000, heads: int = 4,
          head_dim: int = 32, feat_dim: int = 128, out_dim: int = 16,
          device=None):
    """``(fn, args)`` with ``fn(state_dict, x, q, be_packed) -> (logits,
    attn)``.

    The graph is ``random_graph(n_nodes, n_edges, seed=0,
    power_law=True)`` with its ``ell_dual`` packing; x ``(n, feat_dim)``,
    q ``(n, heads, head_dim)`` and the edge features ``(E_pad,
    head_dim)`` come from ``numpy.random.default_rng(0)`` in the
    reference's order; the model is ``GAT(hidden_dim=heads·head_dim,
    out_dim, num_layers=2, num_heads=heads, remat=True,
    dtype=torch.bfloat16)`` with parameters drawn from a
    ``torch.Generator`` seeded 1. ``args`` is (the model's parameters by
    name, x, q, the packed edge features). ``fn`` runs the model through
    ``torch.func.functional_call`` on the given tensors; the remat'd
    layers recompute their forward in the backward from the module's own
    parameters, so take gradients with ``args[0]`` (which holds them).

    Everything lives on ``device``: the CUDA device unless the caller
    names another; with no card and no device it raises.
    """
    if device is None:
        from custom_op_benchmark_tpu_torch.utils.device import cuda_device

        device = cuda_device()
    device = torch.device(device)
    g = random_graph(n_nodes, n_edges, seed=0, power_law=True, device=device)
    se, de = ell_dual(g)

    rng = np.random.default_rng(0)
    x = rng.normal(size=(n_nodes, feat_dim)).astype(np.float32)
    q = rng.normal(size=(n_nodes, heads, head_dim)).astype(np.float32)
    be = rng.normal(size=(g.num_edges_padded, head_dim)).astype(np.float32)
    be_packed = ell_pack_weights(se, de, torch.from_numpy(be).to(device))

    model = GAT(hidden_dim=heads * head_dim, out_dim=out_dim, num_layers=2,
                num_heads=heads, remat=True, dtype=torch.bfloat16,
                in_dim=feat_dim,
                generator=torch.Generator().manual_seed(1)).to(device)

    def fn(state_dict, x, q, be_packed):
        logits = functional_call(model, state_dict, (g, x),
                                 {"ell": (se, de)})
        attn = ell_edge_bias_attention(de, se, q, q, q, be_packed)
        return logits, attn

    params = dict(model.named_parameters())
    return fn, (params, torch.from_numpy(x).to(device),
                torch.from_numpy(q).to(device), be_packed)
