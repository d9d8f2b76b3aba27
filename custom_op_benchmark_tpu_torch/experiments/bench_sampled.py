"""The sampled-minibatch step, apart: host sampling, the device step and
the pipelined step.

Counterpart of scripts/bench_sampled.py, on reddit_sage's configuration
(``train/run.py``: the reddit-like stand-in, 233,700 nodes, 300-d
features, degree 50; ``GraphSAGE(128, 2 layers)``, fanouts (25, 10), 256
seeds a batch). Over the same N batches it times

    host_sampling_ms     ``NeighborSampler.sample`` alone (the native
                         draws and the batch's dual CSR), a batch, by the
                         host clock; ``dual_csr_ms`` is the part of it in
                         ``from_coo`` (the batch's dual CSR)
    device_step_ms       the N batches sampled beforehand and on the card,
                         N steps enqueued back to back and one
                         synchronisation at the end, a step
    pipelined_step_ms    the same steps fed by ``data/pipeline.py``'s
                         ``prefetch`` (sampling in its thread, copies on a
                         side stream), one synchronisation at the end
    idle_share           the device's idle share over steps of the
                         pipelined run (``benchlib.trace_fn``, every
                         thread recorded: the trace in ``trace_dir`` shows
                         the prefetch thread's ``data.sample`` and
                         ``data.to_device`` beside ``train.step``)

and the bytes each step sends to the card (every tensor of a prefetched
batch). The presampled and the pipelined runs start from two states drawn
from the same seed and take the same batches (two samplers of one seed), so
their final losses must be equal bit for bit: the driver exits 1 when they
are not.

Runs on the CUDA device, ``--small`` at 1/20 of the graph (64-d, degree
15), or with ``--device cpu`` at 1/100 for 3 steps, timing nothing.
:func:`run` takes a dataset that is already built.

Run:  python -m custom_op_benchmark_tpu_torch.experiments.bench_sampled [--small | --device cpu]
"""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from custom_op_benchmark_tpu_torch.data import pipeline, sampling
from custom_op_benchmark_tpu_torch.experiments import common
from custom_op_benchmark_tpu_torch.train import run as cli
from custom_op_benchmark_tpu_torch.train.loop import (
    create_train_state,
    make_sampled_step,
    sampled_batches,
)
from custom_op_benchmark_tpu_torch.utils.benchlib import (
    read_summary,
    trace_fn,
)

SCALE = {"full": 1, "small": 0.05, "cpu": 0.01}
STEPS = {"full": 30, "small": 8, "cpu": 3}
TRACE_STEPS = {"full": 10, "small": 4, "cpu": 2}
SEED = 0


def fresh_state(ds, device, seed=SEED):
    """reddit_sage's model drawn from ``seed`` on ``device`` and its AdamW."""
    model = cli.reddit_sage_model(ds)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return create_train_state(model.to(device), learning_rate=1e-3)


def batch_source(ds, steps, seed=SEED):
    """The first ``steps`` batches of one epoch of a sampler drawn from
    ``seed``, as ``train.loop.sampled_batches`` yields them (host)."""
    sampler = sampling.NeighborSampler(ds.graph, cli.REDDIT_FANOUTS,
                                       seed=seed)
    train_ids = np.nonzero(ds.train_mask)[0][: steps * cli.REDDIT_BATCH]
    return sampled_batches(sampler, train_ids, cli.REDDIT_BATCH)


def step_on(step, state, feats, labels, item):
    """One sampled step on a batch ``item`` whose tensors are on the
    device: features and labels gathered there by its ids."""
    g, ids, seeds, mask, cols = item
    return step(state, g, feats[ids], labels[seeds], mask, cols)


def presampled_run(state, step, feats, labels, items):
    """The steps over batches already on the device; the last loss."""
    loss = None
    for item in items:
        loss = step_on(step, state, feats, labels, item)
    return loss


def pipelined_run(state, step, feats, labels, source, device):
    """The steps over ``source``'s batches through ``prefetch`` (depth 2,
    copies to ``device``); the last loss."""
    loss = None
    for item in pipeline.prefetch(source, 2, device=device):
        loss = step_on(step, state, feats, labels, item)
    return loss


def item_bytes(item) -> int:
    """Bytes of every tensor that a prefetched batch moves to the card."""
    total = []
    pipeline.map_tensors(item, lambda t: total.append(
        t.numel() * t.element_size()) or t)
    return sum(total)


def host_sampling(ds, steps):
    """Host seconds a batch of ``sample`` and of its ``from_coo`` (the dual
    CSR), over ``steps`` batches of a sampler drawn from ``SEED``; the
    batches."""
    csr = []
    inner = sampling.from_coo

    def timed_from_coo(*a, **kw):
        t0 = time.perf_counter()
        out = inner(*a, **kw)
        csr.append(time.perf_counter() - t0)
        return out

    sampling.from_coo = timed_from_coo
    try:
        t0 = time.perf_counter()
        items = list(batch_source(ds, steps))
        total = time.perf_counter() - t0
    finally:
        sampling.from_coo = inner
    return total / len(items), sum(csr) / len(items), items


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(device: torch.device, size: str = "full", ds=None, feats=None,
        labels=None, trace_dir=None) -> dict:
    """The driver on ``device`` at ``size`` ("full", "small", "cpu"): on
    ``ds`` (default: reddit_sage's dataset at the size's scale) with its
    features and labels on the device where given (``feats``,
    ``labels``)."""
    timed = device.type == "cuda"
    if ds is None:
        t0 = time.perf_counter()
        ds = cli.reddit_dataset(SCALE[size])
        print(f"dataset: n={ds.graph.n_nodes} e={ds.graph.n_edges} "
              f"features {ds.features.shape}; host build "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    if feats is None:
        feats = torch.from_numpy(ds.features).to(device)
    if labels is None:
        labels = torch.from_numpy(ds.labels.astype(np.int64)).to(device)
    steps = STEPS[size]
    step = make_sampled_step()

    sample_s, csr_s, items = host_sampling(ds, steps)
    per_step_bytes = item_bytes(items[0])
    on_dev = [pipeline.map_tensors(it, lambda t: t.to(device))
              for it in items]
    # A warm-up step on a state of its own, so both timed runs start from
    # the seed's weights.
    step_on(step, fresh_state(ds, device), feats, labels, on_dev[0])
    sync(device)

    state_a = fresh_state(ds, device)
    t0 = time.perf_counter()
    loss_a = presampled_run(state_a, step, feats, labels, on_dev)
    sync(device)
    device_s = (time.perf_counter() - t0) / steps

    state_b = fresh_state(ds, device)
    t0 = time.perf_counter()
    loss_b = pipelined_run(state_b, step, feats, labels,
                           batch_source(ds, steps), device)
    sync(device)
    pipe_s = (time.perf_counter() - t0) / steps
    same = bool(torch.equal(loss_a, loss_b))

    # The pipelined steps under the profiler, on state_b's next batches.
    trace_steps = TRACE_STEPS[size]
    it = pipeline.prefetch(batch_source(ds, steps + trace_steps), 2,
                           device=device)
    for _ in range(steps):
        next(it)

    def one(f):
        return step_on(step, state_b, f, labels, next(it))

    with tempfile.TemporaryDirectory() as tmp:
        out = trace_fn(one, (feats,), str(Path(trace_dir or tmp)
                                          / "bench_sampled"),
                       iters=trace_steps - 1)
        prof = read_summary(out)
    del it

    n_sub = int(items[0][1].shape[0])
    result = dict(
        device=common.where(device), n=ds.graph.n_nodes, e=ds.graph.n_edges,
        feat_dim=int(ds.features.shape[1]), batch=cli.REDDIT_BATCH,
        fanouts=list(cli.REDDIT_FANOUTS), steps=steps,
        subgraph_nodes=n_sub,
        host_sampling_ms=sample_s * 1e3, dual_csr_ms=csr_s * 1e3,
        device_step_ms=device_s * 1e3 if timed else None,
        pipelined_step_ms=pipe_s * 1e3 if timed else None,
        idle_share=prof["idle_share"], busy_ms=prof["busy_ms"],
        window_ms=prof["window_ms"], top=prof["top"][:5],
        per_step_bytes=per_step_bytes,
        feature_rows_bytes=n_sub * int(ds.features.shape[1]) * 4,
        final_loss=float(loss_a), same_final_loss=same, ok=same)
    print(f"host sampling {result['host_sampling_ms']:.2f} ms a batch "
          f"(dual CSR {result['dual_csr_ms']:.2f}); "
          + (f"device step {result['device_step_ms']:.2f} ms, pipelined "
             f"{result['pipelined_step_ms']:.2f} ms, idle share "
             f"{prof['idle_share']:.3f}" if timed else
             "device times not measured (no CUDA device)")
          + f"; {per_step_bytes / 1024:.1f} KiB a step to the device; "
          f"presampled and pipelined final losses equal: {same}",
          flush=True)
    return result


def main(argv=None) -> int:
    return common.run_main("bench_sampled", __doc__, run, argv)


if __name__ == "__main__":
    sys.exit(main())
