"""The command line for the end-to-end configurations.

    python -m custom_op_benchmark_tpu_torch.train.run --config NAME
        [--scale S] [--epochs E] [--device cpu]

Counterpart of custom_op_benchmark_tpu/train/run.py. Each run trains on a
synthetic stand-in (``data.synthetic.planted_partition`` at the named
scale; ``--scale`` shrinks the node count) and prints one JSON line
``{"config", "scale", "data", **metrics}``. Ported configurations:

  cora_gat            a 2-layer GAT (8 heads of 64), full graph, on the
                      segment path, after config 1's validation: one
                      attention layer on the segment ops against a dense
                      masked oracle, forward and the gradients of q, k and
                      v (rtol 1e-3, atol 1e-4, TF32 off), reported as
                      ``layer_allclose_ok``;
  arxiv_gat           a 3-layer GAT (4 heads of 128), full graph, on the
                      fused ELL path (``fit_full_graph(strategy="ell")``);
  arxiv_transformer   GraphTransformer(dim 128, 4 heads, 3 layers) on the
                      fused ELL attention.

The table lists every configuration of the reference, so ``--help`` names
them all; ``reddit_sage`` waits for sampling (ROADMAP M10), the three
distributed ones for the distributed plans (ROADMAP M12), and ``--data``
for the dataset loaders (ROADMAP M10): they raise ``NotImplementedError``
and the command exits non-zero.

Training runs on the CUDA device, or with ``--device cpu`` on the CPU at a
scale below 1 only (the kernels' plain versions stand in).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from typing import Callable, Optional

import numpy as np
import torch

from custom_op_benchmark_tpu_torch.data.synthetic import planted_partition

# config 1's validation: one attention layer on the segment ops against
# the dense masked oracle (the reference's gate, run.py:94-101).
LAYER_RTOL, LAYER_ATOL = 1e-3, 1e-4
LAYER_WIDTH = 16


def _ds(num_classes, nodes_per_class, feat_dim, scale, **kw):
    return planted_partition(num_classes=num_classes,
                             nodes_per_class=max(8, int(nodes_per_class
                                                        * scale)),
                             feat_dim=feat_dim, **kw)


def cora_dataset(scale):
    return _ds(7, 387, 1433 if scale >= 1 else 64, scale, name="cora-like")


def arxiv_dataset(scale):
    return _ds(40, 4000, 128, scale, avg_degree=13, name="arxiv-like")


def cora_gat_model(ds):
    from custom_op_benchmark_tpu_torch.models import GAT

    return GAT(hidden_dim=64, out_dim=ds.num_classes, num_layers=2,
               num_heads=8, in_dim=ds.features.shape[1])


def arxiv_gat_model(ds):
    from custom_op_benchmark_tpu_torch.models import GAT

    return GAT(hidden_dim=128, out_dim=ds.num_classes, num_layers=3,
               num_heads=4, in_dim=ds.features.shape[1])


def arxiv_transformer_model(ds):
    from custom_op_benchmark_tpu_torch.models import GraphTransformer

    return GraphTransformer(dim=128, num_heads=4, num_layers=3,
                            out_dim=ds.num_classes,
                            in_dim=ds.features.shape[1])


@dataclasses.dataclass(frozen=True)
class Setup:
    """A ported configuration: its dataset at a scale, its model for a
    dataset, its strategy and learning rate."""

    dataset: Callable
    model: Callable
    strategy: Optional[str]
    learning_rate: float


SETUPS = {
    "cora_gat": Setup(cora_dataset, cora_gat_model, None, 5e-3),
    "arxiv_gat": Setup(arxiv_dataset, arxiv_gat_model, "ell", 2e-3),
    "arxiv_transformer": Setup(arxiv_dataset, arxiv_transformer_model,
                               "ell", 1e-3),
}


def layer_allclose(g, device, seed: int = 0) -> bool:
    """Config 1's validation on ``g``: ``sddmm → edge_softmax(by="src") →
    vector_spmm`` and the sum of squares of its output, against the dense
    masked attention, forward and the gradients of q, k and v."""
    from custom_op_benchmark_tpu_torch.ops import (
        edge_softmax,
        sddmm,
        vector_spmm,
    )
    from custom_op_benchmark_tpu_torch.utils.device import exact_f32

    n, d = g.n_nodes, LAYER_WIDTH
    rng = np.random.default_rng(seed)
    qkv = [torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32))
           .to(device).requires_grad_() for _ in range(3)]
    adj = torch.zeros(n, n, dtype=torch.bool, device=device)
    adj[g.src.long()[: g.n_edges], g.dst.long()[: g.n_edges]] = True

    def layer_seg(q, k, v):
        s = sddmm(g, q, k) / math.sqrt(d)
        a = edge_softmax(g, s, by="src")
        return (vector_spmm(g, a, v) ** 2).sum()

    def layer_dense(q, k, v):
        s = torch.where(adj, q @ k.T / math.sqrt(d), -1e30)
        a = torch.where(adj, torch.softmax(s, -1), 0.0)
        return ((a @ v) ** 2).sum()

    with exact_f32():
        ls, ld = layer_seg(*qkv), layer_dense(*qkv)
        ok = math.isclose(ls.item(), ld.item(), rel_tol=LAYER_RTOL)
        for a, b in zip(torch.autograd.grad(ls, qkv),
                        torch.autograd.grad(ld, qkv)):
            ok &= bool(torch.allclose(a, b, rtol=LAYER_RTOL,
                                      atol=LAYER_ATOL))
    return ok


def train(name, scale, epochs, device):
    """Train configuration ``name`` and return its metrics."""
    from custom_op_benchmark_tpu_torch.train.loop import fit_full_graph

    setup = SETUPS[name]
    ds = setup.dataset(scale)
    metrics = {}
    if name == "cora_gat":
        metrics["layer_allclose_ok"] = layer_allclose(ds.graph.to(device),
                                                      device)
    _, fit = fit_full_graph(setup.model(ds), ds, epochs=epochs,
                            learning_rate=setup.learning_rate,
                            strategy=setup.strategy, device=device)
    metrics.update(fit)
    return metrics


def _ported(name):
    def run(scale, epochs, device):
        return train(name, scale, epochs, device)

    return run


def _refused(item, what):
    def run(scale, epochs, device):
        raise NotImplementedError(f"{what} is not ported yet (ROADMAP "
                                  f"{item})")

    return run


CONFIGS = {
    "cora_gat": (_ported("cora_gat"), 100),
    "arxiv_gat": (_ported("arxiv_gat"), 60),
    "arxiv_transformer": (_ported("arxiv_transformer"), 40),
    "reddit_sage": (_refused("M10", "reddit_sage's neighbour sampling"), 2),
    "products_gat_dist": (_refused(
        "M12", "products_gat_dist's distributed plan"), 30),
    "products_transformer_dist": (_refused(
        "M12", "products_transformer_dist's distributed plan"), 30),
    "papers100m_gat_dist": (_refused(
        "M12", "papers100m_gat_dist's distributed plan"), 10),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True, choices=sorted(CONFIGS))
    ap.add_argument("--scale", type=float, default=1.0,
                    help="dataset size multiplier (use <1 for smoke runs)")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--data", type=str, default=None,
                    help="path to a real dataset (OGB directory, canonical "
                    ".npz, or Planetoid-style .npz); not ported yet")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to train (default: the CUDA device, and "
                    "fail without one); cpu at --scale below 1 only")
    args = ap.parse_args(argv)
    if args.data is not None:
        raise NotImplementedError("--data needs the dataset loaders "
                                  "(data/datasets.py), not ported yet "
                                  "(ROADMAP M10)")
    fn, default_epochs = CONFIGS[args.config]
    if args.device == "cpu":
        if args.scale >= 1:
            print("run: the full-size configurations train on the CUDA "
                  "device only (pass --scale below 1)", file=sys.stderr)
            return 1
        device = torch.device("cpu")
    else:
        from custom_op_benchmark_tpu_torch.utils.device import cuda_device

        try:
            device = cuda_device()
        except RuntimeError as err:
            print(f"run: {err} (pass --device cpu with --scale below 1)",
                  file=sys.stderr)
            return 1
    metrics = fn(args.scale, args.epochs or default_epochs, device)
    print(json.dumps({"config": args.config, "scale": args.scale,
                      "data": args.data, **metrics}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
