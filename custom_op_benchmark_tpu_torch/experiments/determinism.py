"""Bitwise repeatability of the training paths, and the segment path's
step times.

    python -m custom_op_benchmark_tpu_torch.experiments.determinism
        [--times] [--device cpu]

Counterpart of tests/test_determinism.py on the CUDA device. Each case runs
twice from the same inputs, and its outputs and gradients are compared
with ``torch.equal``:

  segment          sddmm → edge_softmax(by="dst") → vector_spmm on the
                   segment ops (``impl="xla"``), forward and the gradients
                   of the edge data and the features;
  ell_attention    the fused ELL attention, forward and gradient;
  block_attention  the dense-block attention, forward and gradient;
  fit_gat:<path>   ``fit_full_graph`` of a GAT for 3 epochs on the segment
                   path (strategy None), ``"ell"`` and ``"block"``: every
                   parameter after training.

The segment and ELL cases run on a power-law graph with hub rows (many
edges into one segment, where a sum with atomics changes its order from
run to run). With ``--times`` it also times one AdamW train step on the
segment path: cora_gat's GAT (2 layers, 8 heads of 64, 1,433 features)
and the arxiv configuration's GAT, GCN and GraphSAGE (hidden 128), by
CUDA events (median of 3 runs of 3 steps after one). It prints one JSON
line ``{"determinism": {case: bool}, "segment_step_ms": {...}}`` and
exits 1 if a case did not repeat.

It uses only the package's public functions, so it also runs against
another checkout of the package (``PYTHONPATH=that/checkout python
path/to/determinism.py``), which is how a change is compared with its
parent on one card. ``--device cpu`` runs the cases at a tenth of the
size as a smoke run (no times).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np
import torch

# The sizes on the card: a power-law graph with hub rows, and the block
# case's clique batch.
POWERLAW = dict(n_nodes=32768, n_edges=1_000_000, d=64)
CLIQUES = (512, 30)
FIT_EPOCHS = 3


def same_bits(a, b) -> bool:
    """True if two lists of tensors are equal bit for bit."""
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def repeats(fn) -> bool:
    """Run ``fn()`` (a list of tensors) twice; True if bit for bit equal."""
    first = [t.detach().clone() for t in fn()]
    second = [t.detach().clone() for t in fn()]
    return same_bits(first, second)


def segment_case(g, x, ed):
    from custom_op_benchmark_tpu_torch.ops import (
        edge_softmax,
        sddmm,
        vector_spmm,
    )

    def run():
        xx = x.clone().requires_grad_()
        ee = ed.clone().requires_grad_()
        s = sddmm(g, xx, xx, impl="xla")
        a = edge_softmax(g, s, by="dst", impl="xla")
        y = vector_spmm(g, a * ee, xx, impl="xla")
        dx, de = torch.autograd.grad((y ** 2).sum(), (xx, ee))
        return [y, dx, de]

    return run


def ell_case(g, x):
    from custom_op_benchmark_tpu_torch.ops import ell_attention, ell_dual

    se, de = ell_dual(g)

    def run():
        q = x.clone().requires_grad_()
        y = ell_attention(de, se, q, q, q)
        (dq,) = torch.autograd.grad((y ** 2).sum(), (q,))
        return [y, dq]

    return run


def block_case(device):
    from custom_op_benchmark_tpu_torch.graph import block_graph, clique_batch
    from custom_op_benchmark_tpu_torch.ops import block_attention

    g = clique_batch(*CLIQUES, device=device)
    bg = block_graph(g)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((g.n_nodes, 64),
                                             dtype=np.float32)).to(device)

    def run():
        xb = bg.scatter_nodes(x.clone().requires_grad_())
        y = block_attention(bg, xb, xb, xb)
        (dxb,) = torch.autograd.grad((y ** 2).sum(), (xb,))
        return [y, dxb]

    return run


def _cliques_dataset(g, feat=64, classes=10, seed=10):
    from custom_op_benchmark_tpu_torch.data.synthetic import (
        NodeClassificationDataset,
    )

    rng = np.random.default_rng(seed)
    n = g.n_nodes
    train = rng.random(n) < 0.6
    return NodeClassificationDataset(
        graph=g, features=rng.standard_normal((n, feat), dtype=np.float32),
        labels=rng.integers(0, classes, size=n).astype(np.int32),
        train_mask=train, val_mask=~train, test_mask=np.zeros(n, bool),
        num_classes=classes, name="cliques")


def fit_case(ds, strategy, device):
    from custom_op_benchmark_tpu_torch.models import GAT
    from custom_op_benchmark_tpu_torch.train import fit_full_graph

    def run():
        model = GAT(hidden_dim=16, out_dim=ds.num_classes, num_layers=2,
                    num_heads=4, in_dim=ds.features.shape[1])
        state, metrics = fit_full_graph(model, ds, epochs=FIT_EPOCHS,
                                        seed=7, strategy=strategy,
                                        device=device)
        return ([p.detach() for p in state.model.parameters()]
                + [torch.tensor(metrics["val_loss"])])

    return run


def cases(device, scale: float = 1.0):
    """The named cases, each a function of no arguments returning the
    tensors to compare."""
    from custom_op_benchmark_tpu_torch.data import planted_partition
    from custom_op_benchmark_tpu_torch.graph import clique_batch, random_graph

    n = max(64, int(POWERLAW["n_nodes"] * scale))
    e = max(640, int(POWERLAW["n_edges"] * scale))
    g = random_graph(n, e, seed=0, power_law=True, device=device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (g.n_nodes, POWERLAW["d"]), dtype=np.float32)).to(device)
    ed = torch.from_numpy(rng.uniform(size=g.num_edges_padded)
                          .astype(np.float32)).to(device)
    pp = planted_partition(num_classes=10,
                           nodes_per_class=max(20, int(2000 * scale)),
                           feat_dim=32, avg_degree=13, seed=0)
    cl = _cliques_dataset(clique_batch(*CLIQUES))
    return {
        "segment": segment_case(g, x, ed),
        "ell_attention": ell_case(g, x),
        "block_attention": block_case(device),
        "fit_gat:segment": fit_case(pp, None, device),
        "fit_gat:ell": fit_case(pp, "ell", device),
        "fit_gat:block": fit_case(cl, "block", device),
    }


def repeat_all(device, scale: float = 1.0) -> dict:
    """{case: True if it repeated bit for bit}."""
    return {name: repeats(fn) for name, fn in cases(device, scale).items()}


def segment_step_ms(device) -> dict:
    """One AdamW train step on the segment path, ms: cora_gat's GAT and the
    arxiv configuration's GAT, GCN and GraphSAGE."""
    from custom_op_benchmark_tpu_torch import models
    from custom_op_benchmark_tpu_torch.data import planted_partition
    from custom_op_benchmark_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )
    from custom_op_benchmark_tpu_torch.utils.benchlib import time_cuda

    cora = planted_partition(num_classes=7, nodes_per_class=387,
                             feat_dim=1433, name="cora-like")
    arxiv = planted_partition(num_classes=40, nodes_per_class=4000,
                              feat_dim=128, avg_degree=13, name="arxiv-like")
    setups = {
        "cora_gat GAT": (cora, "GAT", dict(hidden_dim=64, num_layers=2,
                                           num_heads=8)),
        "arxiv GAT": (arxiv, "GAT", dict(hidden_dim=128, num_layers=3,
                                         num_heads=4)),
        "arxiv GCN": (arxiv, "GCN", dict(hidden_dim=128, num_layers=2)),
        "arxiv GraphSAGE": (arxiv, "GraphSAGE", dict(hidden_dim=128,
                                                     num_layers=2)),
    }
    out = {}
    for key, (ds, arch, kw) in setups.items():
        g = ds.graph.to(device)
        x = torch.from_numpy(ds.features).to(device)
        labels = torch.from_numpy(ds.labels).to(device)
        mask = torch.from_numpy(ds.train_mask).to(device)
        model = getattr(models, arch)(
            out_dim=ds.num_classes, in_dim=x.shape[1], **kw,
            generator=torch.Generator().manual_seed(0)).to(device)
        state = create_train_state(model, learning_rate=1e-3)
        step = make_train_step()
        times = time_cuda(lambda: step(state, g, x, labels, mask), warmup=1,
                          iters=3, repeats=3)
        out[key] = statistics.median(times) * 1e3
        del model, state, g, x
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--times", action="store_true",
                    help="also time the segment path's train steps")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: a smoke run at a tenth of the size")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        device, scale = torch.device("cpu"), 0.1
    else:
        from custom_op_benchmark_tpu_torch.utils import cuda_device

        device, scale = cuda_device(), 1.0
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rec = {"determinism": repeat_all(device, scale)}
    if args.times and device.type == "cuda":
        rec["segment_step_ms"] = segment_step_ms(device)
        rec["device"] = torch.cuda.get_device_name(device)
    print(json.dumps(rec), flush=True)
    return 0 if all(rec["determinism"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
