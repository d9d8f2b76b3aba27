"""The command line for the end-to-end configurations.

    python -m custom_op_benchmark_tpu_torch.train.run --config NAME
        [--scale S] [--epochs E] [--data PATH] [--device cpu]

Counterpart of custom_op_benchmark_tpu/train/run.py. Each run trains on a
synthetic stand-in (``data.synthetic.planted_partition`` at the named
scale; ``--scale`` shrinks the node count), or with ``--data`` on a
dataset on disk (``data.datasets.load_dataset``: an OGB directory, a
canonical .npz or a Planetoid-style .npz), and prints one JSON line
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
                      fused ELL attention;
  reddit_sage         GraphSAGE (hidden 128, 2 layers) on fanout (25, 10)
                      neighbour samples of 256 seeds, host sampling
                      overlapped with the device's steps
                      (``fit_sampled``); its metrics add the median step,
                      sampling and evaluation times.

  products_gat_dist   the edge-partitioned GAT (hidden 64, 4 heads, 2
                      layers, Adam 1e-2) of ``parallel.train_dist.
                      fit_edge_partitioned`` on the halo plan (order and
                      hub threshold "auto") over 8 shards: a mesh of 8
                      shards on the one device, or, under an initialised
                      ``torch.distributed`` group (``torchrun``), one shard
                      a process;
  products_transformer_dist
                      the same with the distributed graph transformer;
  papers100m_gat_dist the GAT over 16 shards.

The distributed configurations share the products-like dataset (47
classes of 5,200 nodes, average degree 20; 100-d features at ``--scale``
1, 32-d below it). Their metrics add the plan's host seconds and exchange
numbers (``plan``), the median step time and the peak memory; with
``COB_CACHE_DIR`` set the host plan is cached there (graph/cache.py).

Training runs on the CUDA device, or with ``--device cpu`` on the CPU at a
scale below 1 or with ``--data`` (the kernels' plain versions stand in).
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


def reddit_dataset(scale):
    """reddit_sage's stand-in: 41 classes of 5,700 nodes, 300-d features and
    average degree 50 at ``--scale 1``; below it 64-d and degree 15."""
    full = scale >= 1
    return _ds(41, 5700, 300 if full else 64, scale,
               avg_degree=50 if full else 15, name="reddit-like")


def cora_gat_model(ds):
    from custom_op_benchmark_tpu_torch.models import GAT

    return GAT(hidden_dim=64, out_dim=ds.num_classes, num_layers=2,
               num_heads=8, in_dim=ds.features.shape[1])


def arxiv_gat_model(ds):
    from custom_op_benchmark_tpu_torch.models import GAT

    return GAT(hidden_dim=128, out_dim=ds.num_classes, num_layers=3,
               num_heads=4, in_dim=ds.features.shape[1])


def reddit_sage_model(ds):
    from custom_op_benchmark_tpu_torch.models import GraphSAGE

    return GraphSAGE(hidden_dim=128, out_dim=ds.num_classes, num_layers=2,
                     in_dim=ds.features.shape[1])


def arxiv_transformer_model(ds):
    from custom_op_benchmark_tpu_torch.models import GraphTransformer

    return GraphTransformer(dim=128, num_heads=4, num_layers=3,
                            out_dim=ds.num_classes,
                            in_dim=ds.features.shape[1])


@dataclasses.dataclass(frozen=True)
class Setup:
    """A ported configuration: its dataset at a scale, its model for a
    dataset, its strategy (or ``"sampled"`` for ``fit_sampled``) and
    learning rate."""

    dataset: Callable
    model: Callable
    strategy: Optional[str]
    learning_rate: float


SETUPS = {
    "cora_gat": Setup(cora_dataset, cora_gat_model, None, 5e-3),
    "arxiv_gat": Setup(arxiv_dataset, arxiv_gat_model, "ell", 2e-3),
    "arxiv_transformer": Setup(arxiv_dataset, arxiv_transformer_model,
                               "ell", 1e-3),
    "reddit_sage": Setup(reddit_dataset, reddit_sage_model, "sampled",
                         1e-3),
}
# reddit_sage's sampling (custom_op_benchmark_tpu/train/run.py:145-148).
REDDIT_FANOUTS = (25, 10)
REDDIT_BATCH = 256


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


def train(name, scale, epochs, device, data=None):
    """Train configuration ``name`` (on the dataset at ``data`` if given)
    and return its metrics."""
    from custom_op_benchmark_tpu_torch.train.loop import (
        fit_full_graph,
        fit_sampled,
    )

    setup = SETUPS[name]
    if data:
        from custom_op_benchmark_tpu_torch.data.datasets import load_dataset

        ds = load_dataset(data)
    else:
        ds = setup.dataset(scale)
    metrics = {}
    if name == "cora_gat":
        metrics["layer_allclose_ok"] = layer_allclose(ds.graph.to(device),
                                                      device)
    if setup.strategy == "sampled":
        _, fit = fit_sampled(setup.model(ds), ds, fanouts=REDDIT_FANOUTS,
                             batch_size=REDDIT_BATCH, epochs=epochs,
                             learning_rate=setup.learning_rate,
                             device=device)
        fit.pop("losses")
    else:
        _, fit = fit_full_graph(setup.model(ds), ds, epochs=epochs,
                                learning_rate=setup.learning_rate,
                                strategy=setup.strategy, device=device)
    metrics.update(fit)
    return metrics


def _ported(name):
    def run(scale, epochs, device, data=None):
        return train(name, scale, epochs, device, data)

    return run


def products_dataset(scale):
    """The distributed configurations' stand-in: 47 classes of 5,200 nodes,
    average degree 20, 100-d features at ``--scale 1`` (32-d below)."""
    return _ds(47, 5200, 100 if scale >= 1 else 32, scale, avg_degree=20,
               name="products-like")


def dist_mesh(want_devices, device):
    """The distributed configurations' mesh: one shard a process under an
    initialised ``torch.distributed`` group, else ``want_devices`` shards
    on ``device``."""
    import torch.distributed as dist

    from custom_op_benchmark_tpu_torch.parallel import make_mesh

    if dist.is_available() and dist.is_initialized():
        return make_mesh(axis_names=("edge",), group=True)
    return make_mesh((want_devices,), ("edge",), device=device)


def _dist(want_devices, arch="gat"):
    def run(scale, epochs, device, data=None):
        import os

        from custom_op_benchmark_tpu_torch.parallel import (
            fit_edge_partitioned,
        )

        if data:
            from custom_op_benchmark_tpu_torch.data.datasets import (
                load_dataset,
            )

            ds = load_dataset(data)
        else:
            ds = products_dataset(scale)
        _, metrics = fit_edge_partitioned(
            ds, dist_mesh(want_devices, device), hidden=64, num_heads=4,
            num_layers=2, epochs=epochs, arch=arch,
            cache_dir=os.environ.get("COB_CACHE_DIR"))
        return metrics

    return run


CONFIGS = {
    "cora_gat": (_ported("cora_gat"), 100),
    "arxiv_gat": (_ported("arxiv_gat"), 60),
    "arxiv_transformer": (_ported("arxiv_transformer"), 40),
    "reddit_sage": (_ported("reddit_sage"), 2),
    "products_gat_dist": (_dist(8), 30),
    "products_transformer_dist": (_dist(8, "transformer"), 30),
    "papers100m_gat_dist": (_dist(16), 10),
}


def _join_launcher_group(config, device) -> bool:
    """Under a launcher that sets ``WORLD_SIZE`` (``torchrun``), join its
    process group for a distributed configuration: NCCL on the card of
    ``LOCAL_RANK``, gloo on the CPU. Returns whether it did."""
    import os

    import torch.distributed as dist

    if (not config.endswith("_dist") or "WORLD_SIZE" not in os.environ
            or dist.is_initialized()):
        return False
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True, choices=sorted(CONFIGS))
    ap.add_argument("--scale", type=float, default=1.0,
                    help="dataset size multiplier (use <1 for smoke runs)")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--data", type=str, default=None,
                    help="path to a real dataset (OGB directory, canonical "
                    ".npz, or Planetoid-style .npz); omits the synthetic "
                    "stand-in")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to train (default: the CUDA device, and "
                    "fail without one); cpu at --scale below 1 or with "
                    "--data only")
    args = ap.parse_args(argv)
    fn, default_epochs = CONFIGS[args.config]
    if args.device == "cpu":
        if args.scale >= 1 and args.data is None:
            print("run: the full-size configurations train on the CUDA "
                  "device only (pass --scale below 1 or --data)",
                  file=sys.stderr)
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
    started = _join_launcher_group(args.config, device)
    try:
        metrics = fn(args.scale, args.epochs or default_epochs, device,
                     data=args.data)
    finally:
        if started:
            import torch.distributed as dist

            rank = dist.get_rank()
            dist.destroy_process_group()
    if started and rank:
        return 0                        # one line, from rank 0
    print(json.dumps({"config": args.config, "scale": args.scale,
                      "data": args.data, **metrics}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
