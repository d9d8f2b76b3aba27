"""Neighbour aggregation over a fanout-sampled minibatch.

Counterpart of custom_op_benchmark_tpu/ops/sampled.py. Fanout sampling
bounds every in-degree by ``max(fanouts) + 1``, so one dense ``(N, W)``
in-neighbour matrix (``SampledBatch.in_cols``, pad slot ``N``) covers the
batch: the forward is S3 on that one bucket (``gather_sum``, the CUDA
kernel of csrc/gather_sum.cu; the pad slot lies outside x and adds zero).
The backward is the transposed copy-sum over the batch graph's canonical
(src-sorted) edge order, ``dx[u] = Σ_{e: src(e)=u} dy[dst(e)]``: S3's CSR
entry (``csr_sum``) over ``indptr_r``, which sums in a fixed order with
no atomics; padded edges lie in the scratch segment ``N`` and their
``dst`` is ``N``, so they add nothing. The forward and the backward run
inside the spans ``sampled.copy_spmm.fwd`` / ``.bwd`` (``utils.spans``).
"""

from __future__ import annotations

import torch

from custom_op_benchmark_tpu_torch.graph.graph import Graph
from custom_op_benchmark_tpu_torch.ops.kernels.gather_sum import (
    csr_sum,
    gather_sum,
)
from custom_op_benchmark_tpu_torch.utils.spans import spanned


class _SampledCopySum(torch.autograd.Function):
    @staticmethod
    @spanned("sampled.copy_spmm.fwd")
    def forward(ctx, cols, x, ptr, dst):
        ctx.save_for_backward(ptr, dst)
        return gather_sum(cols, x.contiguous())

    @staticmethod
    @spanned("sampled.copy_spmm.bwd")
    def backward(ctx, dy):
        ptr, dst = ctx.saved_tensors
        return None, csr_sum(ptr, dy.contiguous(), dst), None, None


def sampled_copy_spmm(in_cols: torch.Tensor, g: Graph, x: torch.Tensor, *,
                      reduce: str = "mean") -> torch.Tensor:
    """Unweighted in-neighbour aggregation over a sampled batch.

    ``in_cols``: (N, W) int32 in-neighbour matrix (pad slot N); ``g``: the
    batch's padded Graph (its canonical src/dst drive the VJP); ``x``:
    (N, d). ``reduce="mean"`` divides by the number of real slots of each
    row, at least 1.
    """
    if reduce not in ("sum", "mean"):
        raise ValueError(f"reduce must be sum/mean, got {reduce!r}")
    n = x.shape[0]
    if in_cols.dim() != 2 or in_cols.shape[0] != n or n != g.n_nodes:
        raise ValueError(f"in_cols {tuple(in_cols.shape)}, x {tuple(x.shape)}"
                         f" and the graph's {g.n_nodes} nodes disagree")
    y = _SampledCopySum.apply(in_cols, x, g.indptr_r[: n + 1], g.dst)
    if reduce == "sum":
        return y
    deg = (in_cols < n).sum(1).to(x.dtype).clamp(min=1)
    return y / deg[:, None]
