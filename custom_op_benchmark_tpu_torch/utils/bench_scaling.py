"""Shard-count sweeps of the distributed plans on one card.

    python -m custom_op_benchmark_tpu_torch.utils.bench_scaling [--small]
        [--n N --e E --d D] [--device cpu]

Counterpart of custom_op_benchmark_tpu/utils/bench_scaling.py without its
ICI projection (``run_projection``, ``run_dp_projection``, ``--project``,
``--dp-project``: TPU link constants). The port's meshes here are local:
P shards in one process on one card, so a record is "P shards on one
H100" — the cost of partitioning the same work P ways (padding, exchange
copies, per-shard launches), never a scaling efficiency across chips.
Each record says so in ``"layout"``.

- :func:`run_scaling` — ``halo_attention_ell`` forward and forward +
  backward at P = 1, 2, 4, 8, 16 on one power-law graph (cluster order,
  optionally the hub split), with the exchange's accounting: real and
  padded rows, bytes per exchange, interior row share;
- :func:`run_tp_scaling` — ``tp_attention`` with the heads split 1, 2, 4,
  8 ways;
- :func:`run_dp_scaling` — one ``fit_sampled_dp``-style step (P sampled
  GraphSAGE batches, gradients averaged in shard order, one AdamW step)
  on pre-sampled batches (``train.loop.dp_step``).

On the card the times are CUDA-event medians (``benchlib.time_cuda``);
with ``--device cpu`` every case runs once to check it and the times are
null (not measured).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np
import torch

LAYOUT = "P shards on one card (local mesh)"


def _timer(device, iters):
    """``time(fn) -> ms`` on the card; on the CPU it runs ``fn`` once and
    returns None."""
    if device.type != "cuda":
        def once(fn):
            fn()
            return None
        return once
    from custom_op_benchmark_tpu_torch.utils.benchlib import time_cuda

    warmup, reps = iters

    def timed(fn):
        return statistics.median(time_cuda(fn, warmup=warmup, iters=reps,
                                           repeats=3, device=device)) * 1e3
    return timed


def _device(device):
    if device is None:
        from custom_op_benchmark_tpu_torch.utils.device import cuda_device

        return cuda_device()
    return torch.device(device)


def run_scaling(n=65536, e=1_000_000, d=64, heads=2, device_counts=None,
                cluster=True, hub_threshold=None, device=None,
                iters=(2, 5)):
    """``halo_attention_ell`` over P = 1, 2, 4, ... shards of one graph."""
    from custom_op_benchmark_tpu_torch.graph import random_graph, reorder_graph
    from custom_op_benchmark_tpu_torch.graph.cluster import cluster_order
    from custom_op_benchmark_tpu_torch.parallel import (
        halo_attention_ell,
        halo_ell,
        halo_graph,
        make_mesh,
        shard_halo_nodes,
    )
    from custom_op_benchmark_tpu_torch.parallel.halo import plan_summary

    dev = _device(device)
    device_counts = device_counts or [1, 2, 4, 8, 16]
    g = random_graph(n, e, seed=0, power_law=True)
    if cluster:
        g, _ = reorder_graph(g, cluster_order(g, max(device_counts)))
    q0 = np.random.default_rng(0).normal(size=(g.n_nodes, heads, d)).astype(
        np.float32)
    row_bytes = heads * d * 4
    time_ms = _timer(dev, iters)
    records, base = [], None
    for p in device_counts:
        mesh = make_mesh((p,), ("edge",), device=dev)
        hg = halo_graph(g, mesh, hub_threshold=hub_threshold)
        he = halo_ell(hg, mesh)
        q = shard_halo_nodes(hg, mesh, q0)
        qg = q.clone().requires_grad_()

        def fwd():
            return halo_attention_ell(hg, he, mesh, q, q, q)

        def grad():
            y = halo_attention_ell(hg, he, mesh, qg, qg, qg)
            return torch.autograd.grad((y ** 2).sum(), (qg,))

        fwd_ms, grad_ms = time_ms(fwd), time_ms(grad)
        info = plan_summary(hg, he)
        if base is None:
            base = fwd_ms
        records.append(dict(
            shards=p, layout=LAYOUT, fwd_ms=fwd_ms, grad_ms=grad_ms,
            edges_per_s=None if fwd_ms is None else e / fwd_ms * 1e3,
            fwd_vs_one_shard=(None if fwd_ms is None or not base
                              else fwd_ms / base),
            halo_fraction=info["halo_fraction"], n_hub=hg.n_hub,
            comm_rows_real=info["exchange_rows_real"],
            comm_rows_padded=info["exchange_rows_padded"],
            comm_bytes_fwd=2 * info["exchange_rows_padded"] * row_bytes,
            interior_row_frac=info["interior_row_share"]))
    return records


def run_tp_scaling(n=65536, e=1_000_000, d=32, heads=8, device_counts=None,
                   device=None, iters=(2, 5)):
    """``tp_attention`` with the heads split over 1, 2, 4, 8 head shards."""
    from custom_op_benchmark_tpu_torch.graph import random_graph
    from custom_op_benchmark_tpu_torch.ops import ell_dual
    from custom_op_benchmark_tpu_torch.parallel import (
        make_mesh,
        shard_heads,
        tp_attention,
    )

    dev = _device(device)
    device_counts = device_counts or [p for p in (1, 2, 4, 8) if p <= heads]
    g = random_graph(n, e, seed=0, power_law=True, device=dev)
    se, de = ell_dual(g)
    q0 = np.random.default_rng(0).normal(size=(n, heads, d)).astype(
        np.float32)
    time_ms = _timer(dev, iters)
    records = []
    for p in device_counts:
        mesh = make_mesh((p,), ("head",), device=dev)
        q = shard_heads(mesh, q0)
        ms = time_ms(lambda: tp_attention(de, se, mesh, q, q, q))
        records.append(dict(
            shards=p, layout=LAYOUT, ms=ms,
            head_edges_per_s=None if ms is None else e * heads / ms * 1e3))
    return records


def run_dp_scaling(nodes_per_class=2048, feat_dim=64, fanouts=(10, 5),
                   batch_size=256, device_counts=None, device=None,
                   iters=(2, 5)):
    """One data-parallel sampled GraphSAGE step over P pre-sampled batches
    (host sampling left out), the gradients averaged in shard order."""
    from custom_op_benchmark_tpu_torch.data import (
        NeighborSampler,
        planted_partition,
    )
    from custom_op_benchmark_tpu_torch.models import GraphSAGE
    from custom_op_benchmark_tpu_torch.parallel import make_mesh
    from custom_op_benchmark_tpu_torch.train import create_train_state
    from custom_op_benchmark_tpu_torch.train.loop import dp_step

    dev = _device(device)
    device_counts = device_counts or [1, 2, 4, 8]
    ds = planted_partition(nodes_per_class=nodes_per_class,
                           feat_dim=feat_dim, avg_degree=10, seed=0)
    sampler = NeighborSampler(ds.graph, fanouts, seed=0)
    train_ids = np.nonzero(ds.train_mask)[0]
    feats = torch.from_numpy(ds.features).to(dev)
    labels = torch.from_numpy(ds.labels.astype(np.int64)).to(dev)
    model = GraphSAGE(hidden_dim=64, out_dim=ds.num_classes, num_layers=2,
                      in_dim=feat_dim).to(dev)
    state = create_train_state(model, learning_rate=1e-3)
    time_ms = _timer(dev, iters)
    records = []
    for p in device_counts:
        mesh = make_mesh((p,), ("batch",), device=dev)
        batches = []
        for i in range(p):
            b = sampler.sample(train_ids[i * batch_size:(i + 1)
                                         * batch_size])
            batches.append((b.graph.to(dev),
                            torch.from_numpy(b.node_ids.astype(np.int64))
                            .to(dev),
                            torch.from_numpy(b.seed_ids.astype(np.int64))
                            .to(dev),
                            torch.from_numpy(b.seed_mask).to(dev),
                            torch.from_numpy(b.in_cols).to(dev)))

        def step():
            dp_step(state, mesh, "batch", batches, feats, labels)

        ms = time_ms(step)
        records.append(dict(
            shards=p, layout=LAYOUT, step_ms=ms,
            seeds_per_s=None if ms is None else p * batch_size / ms * 1e3))
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--e", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        from custom_op_benchmark_tpu_torch.utils.device import cuda_device

        try:
            dev = cuda_device()
        except RuntimeError as err:
            print(f"bench_scaling: {err} (pass --device cpu)",
                  file=sys.stderr)
            return 1
    else:
        dev = torch.device("cpu")
    if args.small:
        kw = dict(device=dev, iters=(1, 2))
        records = run_scaling(n=2048, e=16000, d=16, **kw)
        hub_records = run_scaling(n=2048, e=16000, d=16,
                                  hub_threshold="auto", **kw)
        tp_records = run_tp_scaling(n=2048, e=16000, d=8, heads=4, **kw)
        dp_records = run_dp_scaling(nodes_per_class=256, batch_size=64,
                                    **kw)
    else:
        records = run_scaling(n=args.n, e=args.e, d=args.d, device=dev)
        hub_records = run_scaling(n=args.n, e=args.e, d=args.d,
                                  hub_threshold="auto", device=dev)
        tp_records = run_tp_scaling(n=args.n, e=args.e, device=dev)
        dp_records = run_dp_scaling(device=dev)
    print(json.dumps({
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu (times not measured)"),
        "scaling": records, "hub_scaling": hub_records,
        "tp_scaling": tp_records, "dp_scaling": dp_records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
