"""One train step of the distributed graph transformer on a local mesh of
one shard.

Counterpart of scripts/bench_dist_transformer.py. The model of
``fit_edge_partitioned(plan="halo", arch="transformer")`` (3 layers,
dim 128, 4 heads of 32, 16 classes, Adam at 1e-3) on
``random_graph(131072, 2M, power_law=True)`` with 128-d random features,
its plan built as that function builds it (``train_dist.build_plan``: the
renumbering ``order="auto"`` picks, hubs at ``hub_threshold="auto"``), at
P = 1. The step is the function's own: forward, masked mean NLL over the
global sum of the mask, backward, the ordered gradient sum, Adam. Prints
the step's ms, edges a second over the 3 layers, the plan's host seconds,
and the loss, which must be finite.

Runs on the CUDA device, ``--small`` on a 16,384-node, 250,000-edge
graph, or with ``--device cpu`` on 512 nodes and 4,000 edges, timing
nothing.

Run:  python -m custom_op_benchmark_tpu_torch.experiments.bench_dist_transformer [--small | --device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F

from custom_op_benchmark_tpu_torch.data.synthetic import (
    NodeClassificationDataset,
)
from custom_op_benchmark_tpu_torch.experiments import common
from custom_op_benchmark_tpu_torch.graph import random_graph
from custom_op_benchmark_tpu_torch.parallel import (
    global_sum,
    make_mesh,
    psum_grads,
)
from custom_op_benchmark_tpu_torch.parallel.train_dist import (
    build_plan,
    dist_transformer_forward,
    init_dist_transformer,
)

FEAT, CLASSES = 128, 16
HEADS, DIM, LAYERS = 4, 128, 3
AXIS = "edge"


def dataset(n, e) -> NodeClassificationDataset:
    """The power-law graph with 128-d normal features, 16 classes, every
    node in the training mask."""
    g = random_graph(n, e, seed=0, power_law=True)
    rng = np.random.default_rng(0)
    ones = np.ones(n, bool)
    return NodeClassificationDataset(
        graph=g, features=rng.standard_normal((n, FEAT), dtype=np.float32),
        labels=rng.integers(0, CLASSES, size=n).astype(np.int32),
        train_mask=ones, val_mask=ones, test_mask=ones, num_classes=CLASSES,
        name="powerlaw")


def make_step(lay, mesh, params, opt):
    """``fit_edge_partitioned``'s train step on the layout ``lay``."""

    def step(x):
        opt.zero_grad(set_to_none=True)
        logits = dist_transformer_forward(lay.dg, mesh, params, x)
        nll = -F.log_softmax(logits, -1).gather(
            -1, lay.labels[:, None])[:, 0]
        den = global_sum(mesh, AXIS, lay.train_mask.sum()).clamp(min=1.0)
        loss = (nll * lay.train_mask).sum() / den
        loss.backward()
        prms = list(params.parameters())
        for prm, gr in zip(prms, psum_grads(mesh, AXIS,
                                            [p.grad for p in prms])):
            prm.grad = gr
        opt.step()
        return global_sum(mesh, AXIS, loss.detach())

    return step


def run(device: torch.device, size: str = "full") -> dict:
    n, e = common.GRAPH[size]
    ds = dataset(n, e)
    mesh = make_mesh((1,), (AXIS,), device=device)
    lay = build_plan(ds, mesh, plan="halo")
    params = init_dist_transformer(0, FEAT, DIM, CLASSES, HEADS,
                                   LAYERS).to(device)
    opt = torch.optim.Adam(params.parameters(), lr=1e-3, betas=(0.9, 0.999),
                           eps=1e-8)
    step = make_step(lay, mesh, params, opt)
    loss = float(step(lay.x))
    rows = common.Rows(device)
    ms = rows("dist_transformer_step", step, lay.x, edges=ds.graph.n_edges)
    plan_s = {k: v for k, v in lay.info.items() if k.endswith("_s")}
    ok = bool(np.isfinite(loss))
    return dict(device=common.where(device), n=n, e=ds.graph.n_edges,
                layers=LAYERS, heads=HEADS, dim=DIM, step_ms=ms,
                edges_per_s=(None if ms is None
                             else ds.graph.n_edges * LAYERS / ms * 1e3),
                plan_host_s=plan_s, order=lay.info.get("order"),
                first_loss=loss, ok=ok)


def main(argv=None) -> int:
    return common.run_main("bench_dist_transformer", __doc__, run, argv)


if __name__ == "__main__":
    sys.exit(main())
