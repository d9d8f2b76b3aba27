"""Sampled-minibatch training as ``train.loop.fit_sampled`` composes it:
``data.sampling.NeighborSampler`` on the host graph that ``from_coo``
builds, ``train.loop.sampled_batches`` over the shuffled train split an
epoch, ``data.pipeline.prefetch`` at the mix's depth (the port's default,
2) copying each batch to the device in a thread while the steps run, the
features kept on the device and gathered there by the batch's node ids,
and ``make_sampled_step``. Epochs follow each other as in
``fit_sampled``: a new sampler epoch and prefetch each.

The benchmark times its own calls into the layers: each batch's sampling
(``sampled_batches``' timings), the training thread's wait for the next
prefetched batch, and each batch's real nodes and edges (read where the
sampler returns it)."""

from __future__ import annotations

import itertools
import statistics
import time

import numpy as np
from torch.profiler import record_function

from custom_op_benchmark_tpu_torch.data.pipeline import prefetch
from custom_op_benchmark_tpu_torch.data.sampling import NeighborSampler
from custom_op_benchmark_tpu_torch.graph.graph import from_coo
from custom_op_benchmark_tpu_torch.train.loop import (
    DEVICE_FEATURES_BYTES,
    make_sampled_step,
    sampled_batches,
)
from gnnbench import capture, counts, spec


class Run:
    def __init__(self, cell, data, family, seed: int, device):
        cfg, mix = cell.config, cell.mix
        self.model_cfg, self.family, self.seed = cfg["model"], family, seed
        self.plain = spec.reference(cfg["family"])
        self.device = device
        feats = data.features
        if feats.numel() * feats.element_size() >= DEVICE_FEATURES_BYTES:
            raise ValueError("the sampled path keeps features on the device "
                             "only below the port's 8 GiB")
        t0 = time.perf_counter()
        graph = from_coo(data.src.cpu().numpy(), data.dst.cpu().numpy(),
                         data.n_nodes)
        t1 = time.perf_counter()
        sampler = NeighborSampler(graph, mix["fanouts"], seed=seed)
        del graph
        t2 = time.perf_counter()
        self.sizes, self.sample_s, self.wait_s = [], [], []
        sample = sampler.sample

        def counted(seeds, **kw):
            b = sample(seeds, **kw)
            self.sizes.append((int(b.node_mask.sum()), b.graph.n_edges))
            return b

        sampler.sample = counted
        train_ids = np.flatnonzero(data.train_mask.cpu().numpy())
        self.feats, self.labels = feats, data.labels
        batch, depth = mix["batch_size"], mix["prefetch_depth"]

        def epochs():
            for _ in itertools.count():
                yield from prefetch(sampled_batches(
                    sampler, train_ids, batch, None, takes_in_cols=True,
                    timings=self.sample_s), depth, device=device)

        self.batches = epochs()
        self.state, self.params0, self.capture = capture.start(
            cfg, family, seed, device, mix["check_steps"], keep_inputs=True)
        self.train_step = make_sampled_step()
        self.blocks = []
        t3 = time.perf_counter()
        for _ in range(mix["check_steps"]):
            loss, b = self._step()
            self.blocks.append(b)
            self.capture.after_step(loss)
        for _ in range(mix["warmup_steps"]):
            self._step()
        self.first = mix["check_steps"] + mix["warmup_steps"]
        self.losses = []
        self.labelled = batch
        self.info = dict(path="sampled", nodes=data.n_nodes,
                         edges=data.n_edges, batch=batch,
                         fanouts=mix["fanouts"], prefetch_depth=depth,
                         host_build_s=t1 - t0, sampler_init_s=t2 - t1,
                         model_s=t3 - t2,
                         first_steps_s=time.perf_counter() - t3,
                         batch_rows=self.blocks[0][0].n_nodes)

    def _step(self, traced: bool = False):
        t = time.perf_counter()
        if traced:
            with record_function("gnnbench.batch_wait"):
                b = next(self.batches)
        else:
            b = next(self.batches)
        self.wait_s.append(time.perf_counter() - t)
        g_b, ids, seeds, mask, cols = b
        loss = self.train_step(self.state, g_b, self.feats[ids],
                               self.labels[seeds], mask, cols)
        return loss, b

    def step(self, traced: bool = False):
        """One step of the window; its loss is kept on the device."""
        self.losses.append(self._step(traced)[0])

    def _window(self, values: list, steps: int) -> list:
        return values[self.first: self.first + steps]

    def counts(self, steps: int) -> dict:
        """Labelled nodes a step, and operations a step over the window's
        batches (their real nodes and edges)."""
        sizes = self._window(self.sizes, steps)
        flops = statistics.fmean(self.plain.forward_flops(self.model_cfg, n, e)
                                 for n, e in sizes) if sizes else 0.0
        return dict(labelled=self.labelled, flops=counts.step_flops(flops),
                    sample_s=self._window(self.sample_s, steps),
                    wait_s=self._window(self.wait_s, steps))

    def probe(self):
        g_b, _, _, _, cols = self.blocks[0]
        n, e = self.sizes[0]
        return self.family.mp_probe(self.model_cfg, {"sampled": (cols, g_b)},
                                    n, e, self.seed, self.device)

    def record(self) -> dict:
        rec = self.capture.record()
        rec["params0"] = self.params0
        rec["blocks"] = [
            dict(node_ids=ids, src=g_b.src[: g_b.n_edges],
                 dst=g_b.dst[: g_b.n_edges], in_cols=cols, seeds=seeds,
                 seed_mask=mask)
            for g_b, ids, seeds, mask, cols in self.blocks]
        return rec

    def close(self):
        """Stop the prefetch thread and drop the program's state."""
        self.batches.close()
        for name in ("state", "train_step", "capture", "blocks", "batches"):
            setattr(self, name, None)

