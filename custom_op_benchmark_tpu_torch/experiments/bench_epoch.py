"""Full-graph epochs at the arxiv-like size, and the halo attention at
P = 1.

Counterpart of scripts/bench_epoch.py. Three parts:

    gat_epoch[f32|bf16]       one full-graph train step (forward, backward,
                              AdamW) of GAT(hidden 128, 3 layers, 4 heads)
                              on the ELL training ladder, over the arxiv-like
                              graph (planted_partition(40 × 4,234, 128-d,
                              degree 7): n = 169,360), in f32 and under the
                              bf16 compute dtype
    transformer_epoch[plain|edge-bias packed]
                              GraphTransformer(128, 4 heads, 3 layers) on the
                              same graph and ladder, plain masked attention
                              and with a (E, 32) edge bias packed in both ELL
                              layouts (``ell_pack_weights``; remat on, as in
                              the reference)
    halo_fwd / halo_bwd       ``halo_attention_ell`` on a local mesh of one
                              shard, ``random_graph(131072, 2M,
                              power_law=True)``, h = 4, d = 32: the forward
                              and the gradient of (out²).sum()

Each epoch's loss must be finite. Timed by ``benchlib.bench_fn``.

Runs on the CUDA device, ``--small`` at 40 × 400 nodes and the 16,384-node
power-law graph, or with ``--device cpu`` at 40 × 20 nodes and 512 nodes,
timing nothing.

Run:  python -m custom_op_benchmark_tpu_torch.experiments.bench_epoch [--small | --device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from custom_op_benchmark_tpu_torch.data.synthetic import planted_partition
from custom_op_benchmark_tpu_torch.experiments import common
from custom_op_benchmark_tpu_torch.graph import random_graph
from custom_op_benchmark_tpu_torch.models import GAT, GraphTransformer
from custom_op_benchmark_tpu_torch.ops import ell_dual, ell_pack_weights
from custom_op_benchmark_tpu_torch.parallel import (
    halo_attention_ell,
    halo_ell,
    halo_graph,
    make_mesh,
    shard_halo_nodes,
)
from custom_op_benchmark_tpu_torch.train import (
    create_train_state,
    make_train_step,
)

NODES_PER_CLASS = {"full": 4234, "small": 400, "cpu": 20}
CLASSES, FEAT, DEGREE = 40, 128, 7
GAT_CFG = dict(hidden_dim=128, out_dim=CLASSES, num_layers=3, num_heads=4)
TX_CFG = dict(dim=128, num_heads=4, num_layers=3, out_dim=CLASSES)
EDGE_DIM = 32
HALO_HEADS, HALO_DIM = 4, 32


def arxiv_like(size, device):
    ds = planted_partition(num_classes=CLASSES,
                           nodes_per_class=NODES_PER_CLASS[size],
                           feat_dim=FEAT, avg_degree=DEGREE, seed=0)
    g = ds.graph.to(device)
    return (ds, g, torch.from_numpy(ds.features).to(device),
            torch.from_numpy(ds.labels.astype(np.int64)).to(device),
            torch.from_numpy(ds.train_mask).to(device))


def epoch_row(rows, name, model, g, x, labels, mask, views):
    """Time one train step of ``model`` (``views`` its keyword arguments)
    and check its loss is finite; the loss."""
    state = create_train_state(model)
    step = make_train_step(apply_kwargs=views)
    loss = step(state, g, x, labels, mask)[0]
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"{name}: the epoch's loss is {loss}")
    rows(name, lambda x: step(state, g, x, labels, mask), x, edges=g.n_edges)
    return float(loss)


def run(device: torch.device, size: str = "full") -> dict:
    ds, g, x, labels, mask = arxiv_like(size, device)
    print(f"arxiv-like: n={g.n_nodes} e={g.n_edges}", flush=True)
    se, de = ell_dual(g, profile="train")
    rows = common.Rows(device)
    losses = {}
    for name, dt in (("f32", None), ("bf16", torch.bfloat16)):
        model = GAT(**GAT_CFG, in_dim=FEAT, dtype=dt,
                    generator=torch.Generator().manual_seed(0)).to(device)
        xin = x if dt is None else x.to(dt)
        losses[f"gat_epoch[{name}]"] = epoch_row(
            rows, f"gat_epoch[{name}]", model, g, xin, labels, mask,
            {"ell": (se, de)})
        del model
    rng = np.random.default_rng(0)
    be = torch.from_numpy(rng.standard_normal(
        (g.n_edges, EDGE_DIM), dtype=np.float32) * 0.1).to(device)
    w = ell_pack_weights(se, de, be)
    for name, views, remat in (
            ("plain", {"ell": (se, de)}, False),
            ("edge-bias packed", {"ell": (se, de), "edge_feat": w}, True)):
        model = GraphTransformer(
            **TX_CFG, in_dim=FEAT, remat=remat,
            generator=torch.Generator().manual_seed(0)).to(device)
        key = f"transformer_epoch[{name}]"
        losses[key] = epoch_row(rows, key, model, g, x, labels, mask, views)
        del model
    del w, be, se, de, g, x

    n, e = common.GRAPH[size]
    hgraph = random_graph(n, e, seed=0, power_law=True)
    mesh = make_mesh((1,), ("edge",), device=device)
    hg = halo_graph(hgraph, mesh)
    he = halo_ell(hg, mesh)
    q = shard_halo_nodes(hg, mesh, rng.standard_normal(
        (n, HALO_HEADS, HALO_DIM), dtype=np.float32)).requires_grad_()

    def attn(q):
        return halo_attention_ell(hg, he, mesh, q, q, q)

    with torch.no_grad():
        rows("halo_fwd", attn, q, edges=hgraph.n_edges)
    rows("halo_bwd", common.sq_grad(attn), q, edges=hgraph.n_edges)
    return dict(device=common.where(device), n=ds.graph.n_nodes,
                e=ds.graph.n_edges, halo_n=n, halo_e=hgraph.n_edges,
                ms=rows.ms, losses=losses)


def main(argv=None) -> int:
    return common.run_main("bench_epoch", __doc__, run, argv)


if __name__ == "__main__":
    sys.exit(main())
