"""Full-graph training as ``train.loop.fit_full_graph(strategy="auto")``
composes it: ``utils.summary.describe`` picks the view (dense blocks where
every component fits one, else the ELL training ladder
``ops.ell.ell_dual(g, profile="train")``), then ``create_train_state`` and
``make_train_step(apply_kwargs=...)``, one step an epoch over the whole
graph, the loss over the train split."""

from __future__ import annotations

import time

from custom_op_benchmark_tpu_torch.graph.blockdiag import block_graph
from custom_op_benchmark_tpu_torch.graph.graph import from_coo
from custom_op_benchmark_tpu_torch.ops.ell import ell_dual
from custom_op_benchmark_tpu_torch.train.loop import (
    make_train_step,
)
from custom_op_benchmark_tpu_torch.utils.summary import describe
from gnnbench import capture, counts, spec


class Run:
    def __init__(self, cell, data, family, seed: int, device):
        cfg, mix = cell.config, cell.mix
        self.model_cfg, self.family, self.seed = cfg["model"], family, seed
        self.plain = spec.reference(cfg["family"])
        self.device = device
        t0 = time.perf_counter()
        graph = from_coo(data.src.cpu().numpy(), data.dst.cpu().numpy(),
                         data.n_nodes)
        t1 = time.perf_counter()
        g = graph.to(device)
        rec = describe(g).recommended
        self.strategy = "block" if rec == "dense_block" else "ell"
        if self.strategy == "ell":
            self.views = {"ell": ell_dual(g, profile="train")}
        else:
            self.views = {"block": block_graph(g)}
        t2 = time.perf_counter()
        self.g, self.n, self.e = g, data.n_nodes, data.n_edges
        self.x, self.labels, self.mask = (data.features, data.labels,
                                          data.train_mask)
        self.labelled = int(data.train_mask.sum())
        self.state, self.params0, self.capture = capture.start(
            cfg, family, seed, device, mix["check_steps"])
        self.train_step = make_train_step(apply_kwargs=self.views)
        t3 = time.perf_counter()
        for _ in range(mix["check_steps"]):
            self.capture.after_step(self._step())
        for _ in range(mix["warmup_steps"]):
            self._step()
        self.losses = []
        self.info = dict(path="full_graph", view=self.strategy,
                         describe=rec, nodes=self.n, edges=self.e,
                         host_build_s=t1 - t0, view_build_s=t2 - t1,
                         model_s=t3 - t2,
                         first_steps_s=time.perf_counter() - t3)
        if self.strategy == "ell":
            src_ell, dst_ell = self.views["ell"]
            self.info.update(
                ell_buckets=[b.width for b in dst_ell.buckets],
                ell_padding=[src_ell.padding_waste, dst_ell.padding_waste])

    def _step(self):
        loss, _ = self.train_step(self.state, self.g, self.x, self.labels,
                                  self.mask)
        return loss

    def step(self, traced: bool = False):
        """One step of the window; its loss is kept on the device."""
        self.losses.append(self._step())

    def counts(self, steps: int) -> dict:
        """Labelled nodes and operations a step of the window."""
        return dict(labelled=self.labelled,
                    flops=counts.step_flops(self.plain.forward_flops(
                        self.model_cfg, self.n, self.e)))

    def probe(self):
        return self.family.mp_probe(self.model_cfg, self.views, self.n,
                                    self.e, self.seed, self.device)

    def record(self) -> dict:
        rec = self.capture.record()
        rec.update(view=self.strategy, params0=self.params0)
        if self.strategy == "ell":
            src_ell, dst_ell = self.views["ell"]
            rec["src_view"] = [(b.rows, b.cols) for b in src_ell.buckets]
            rec["dst_view"] = [(b.rows, b.cols) for b in dst_ell.buckets]
        return rec

    def close(self):
        for name in ("state", "views", "g", "train_step", "capture"):
            setattr(self, name, None)
