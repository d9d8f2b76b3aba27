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


def dryrun_multichip(n_devices: int, *, device=None) -> dict:
    """One SGD step of every distributed plan over ``n_devices`` shards.

    Counterpart of ``dryrun_multichip`` in the JAX package's
    ``__graft_entry__.py``. The shards form a local mesh on ``device``
    (the CUDA device unless the caller names another; every shard on the
    one card). On 8 cliques of 8 nodes: a GAT-style attention layer summed
    over the gather plan (``dist_gat_attention``), the halo plan's segment
    form (``halo_gat_attention``) and its ELL form
    (``halo_attention_ell``), one SGD step of its parameters; then head
    parallelism on a ``("head",)`` mesh (``tp_attention``), the 2-D
    ``("edge", "head")`` mesh (``halo_attention_ell(head_axis="head")``),
    a hub plan with a non-empty hub set on a power-law graph, and the
    distributed transformer. Each loss must be finite; returns them.
    """
    from custom_op_benchmark_tpu_torch.graph import clique_batch
    from custom_op_benchmark_tpu_torch.parallel import (
        dist_gat_attention,
        dist_graph,
        dist_transformer_forward,
        halo_attention_ell,
        halo_ell,
        halo_gat_attention,
        halo_graph,
        init_dist_transformer,
        make_mesh,
        shard_halo_nodes,
        shard_heads,
        tp_attention,
    )
    from custom_op_benchmark_tpu_torch.parallel.shard_ops import shard_nodes

    if device is None:
        from custom_op_benchmark_tpu_torch.utils.device import cuda_device

        device = cuda_device()
    device = torch.device(device)
    mesh = make_mesh((n_devices,), ("edge",), device=device)
    g = clique_batch(8, 8)
    dg = dist_graph(g, mesh)
    f, h, d, classes = 16, 2, 8, 4
    rng = np.random.default_rng(0)
    params = {k: torch.tensor(rng.normal(0, 0.1, s), dtype=torch.float32,
                              device=device, requires_grad=True)
              for k, s in (("wq", (f, h * d)), ("wk", (f, h * d)),
                           ("wv", (f, h * d)), ("wo", (h * d, classes)))}
    x = shard_nodes(dg, mesh, rng.normal(size=(g.n_nodes, f)).astype(
        np.float32))
    labels = shard_nodes(dg, mesh, rng.integers(0, classes, g.n_nodes)
                         .astype(np.int64))
    hgr = halo_graph(g, mesh)
    hel = halo_ell(hgr, mesh)
    assert hgr.n_pad == dg.n_pad      # the same node-sharded layout

    npad = x.shape[0]
    q, k, v = ((x @ params[w]).reshape(npad, h, d)
               for w in ("wq", "wk", "wv"))
    out = (dist_gat_attention(dg, mesh, q, k, v)
           + halo_gat_attention(hgr, mesh, q, k, v)
           + halo_attention_ell(hgr, hel, mesh, q, k, v))
    logits = out.reshape(npad, h * d) @ params["wo"]
    nll = -torch.log_softmax(logits, -1).gather(-1, labels[:, None])[:, 0]
    valid = (torch.arange(npad, device=device) < g.n_nodes).float()
    loss = (nll * valid).sum() / valid.sum()
    grads = torch.autograd.grad(loss, list(params.values()))
    with torch.no_grad():
        for prm, gr in zip(params.values(), grads):
            prm -= 1e-2 * gr
    losses = {"plans": loss.item()}

    # Head parallelism on its own mesh.
    from custom_op_benchmark_tpu_torch.ops import ell_dual

    tp_deg = min(4, n_devices)
    mesh_h = make_mesh((tp_deg,), ("head",), device=device)
    se, de = ell_dual(g.to(device))
    qh = shard_heads(mesh_h, rng.normal(size=(g.n_nodes, tp_deg, d)).astype(
        np.float32)).requires_grad_()
    loss_tp = (tp_attention(de, se, mesh_h, qh, qh, qh) ** 2).sum()
    torch.autograd.grad(loss_tp, (qh,))
    losses["tp"] = loss_tp.item()

    # The 2-D edge × head mesh.
    if n_devices >= 4:
        mesh2 = make_mesh((n_devices // 2, 2), ("edge", "head"),
                          device=device)
        hg2 = halo_graph(g, mesh2)
        hel2 = halo_ell(hg2, mesh2)
        q2 = shard_halo_nodes(hg2, mesh2, rng.normal(
            size=(g.n_nodes, 2, d)).astype(np.float32),
            ("edge", "head")).requires_grad_()
        loss2 = (halo_attention_ell(hg2, hel2, mesh2, q2, q2, q2,
                                    head_axis="head") ** 2).sum()
        torch.autograd.grad(loss2, (q2,))
        losses["edge_x_head"] = loss2.item()

    # A hub plan with a non-empty hub set.
    gph = random_graph(64, 600, seed=5, power_law=True)
    hgh = halo_graph(gph, mesh, hub_threshold=2)
    assert hgh.n_hub > 0, "the hub dry run needs a non-empty hub set"
    heh = halo_ell(hgh, mesh)
    qhub = shard_halo_nodes(hgh, mesh, rng.normal(
        size=(gph.n_nodes, h, d)).astype(np.float32)).requires_grad_()
    lossh = (halo_attention_ell(hgh, heh, mesh, qhub, qhub, qhub)
             ** 2).sum()
    torch.autograd.grad(lossh, (qhub,))
    losses["hub"] = lossh.item()

    # The distributed graph transformer over the halo plan.
    tparams = init_dist_transformer(1, f, h * d, 3, num_heads=h,
                                    num_layers=1).to(device)
    tl = (dist_transformer_forward((hgr, hel), mesh, tparams, x) ** 2).sum()
    torch.autograd.grad(tl, list(tparams.parameters()))
    losses["transformer"] = tl.item()
    bad = {k: v for k, v in losses.items() if not np.isfinite(v)}
    assert not bad, f"non-finite losses: {bad}"
    return losses
