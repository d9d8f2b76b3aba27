"""The user story through the public API: ops, gradients, ``impl=``
dispatch, packed-weight SpMM and training.

Counterpart of scripts/verify_story.py. On ``clique_batch(32, 30)`` at
d = 64, with f32 matmuls in full f32 (the reference's ``"highest"``):

    attention    ``sddmm → edge_softmax → vector_spmm`` and the gradients of
                 (out²).sum() (finite), against ``block_attention`` on the
                 dense blocks at 2e-3
    dispatch     ``impl="auto"`` resolves to the dense blocks and agrees
                 with ``impl="xla"`` at 2e-3; ``impl="pallas"`` reaches the
                 tile kernels' wrapper (the reference's check for a
                 ``pallas_call``), and on the card launches K1 once
    packed SpMM  ``ell_spmm`` on ``ell_pack_weights`` against the canonical
                 weights' ``vector_spmm`` at 2e-3
    training     ``fit_full_graph(GAT(32, 4 classes, 2 heads, 2 layers),
                 planted_partition(4 × 200))`` for 30 epochs: validation
                 accuracy above 0.75

Prints each check and exits 1 when one fails. Times nothing: its card
run is a check, and a few seconds long at every size (``--small`` runs the
same).

Run:  python -m custom_op_benchmark_tpu_torch.experiments.verify_story [--device cpu]
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from custom_op_benchmark_tpu_torch.data.synthetic import planted_partition
from custom_op_benchmark_tpu_torch.experiments import common
from custom_op_benchmark_tpu_torch.graph import block_graph, clique_batch
from custom_op_benchmark_tpu_torch.models import GAT
from custom_op_benchmark_tpu_torch.ops import (
    block_attention,
    dispatch,
    edge_softmax,
    ell_dual,
    ell_pack_weights,
    ell_spmm,
    sddmm,
    vector_spmm,
)
from custom_op_benchmark_tpu_torch.ops import tiled as tiled_ops
from custom_op_benchmark_tpu_torch.ops.kernels import tiled_kernels
from custom_op_benchmark_tpu_torch.train import fit_full_graph
from custom_op_benchmark_tpu_torch.utils.device import exact_f32

TOL = 2e-3
MIN_VAL_ACC = 0.75


def close(a, b) -> float:
    """The largest excess of |a − b| over 2e-3·(1 + |b|) (≤ 0 passes)."""
    return float(((a - b).abs() - TOL * (1 + b.abs())).max())


def reaches_k1(g, q, k) -> bool:
    """``sddmm(impl="pallas")`` calls the K1 wrapper (and launches K1 once
    on the card); ``impl="xla"`` does not."""
    calls = []
    real = tiled_ops.sddmm_tiles

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    tiled_ops.sddmm_tiles = counted
    try:
        sddmm(g, q, k, impl="xla")
        xla_calls = len(calls)
        launches = tiled_kernels.sddmm_tiles.launches
        sddmm(g, q, k, impl="pallas")
        launched = tiled_kernels.sddmm_tiles.launches - launches
    finally:
        tiled_ops.sddmm_tiles = real
    return (xla_calls == 0 and len(calls) == 1
            and (q.device.type != "cuda" or launched == 1))


def run(device: torch.device, size: str = "full") -> dict:
    g = clique_batch(32, 30).to(device)
    n, d = g.n_nodes, 64
    rng = np.random.default_rng(0)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(device)

    q, k, v = normal(n, d), normal(n, d), normal(n, d)
    checks = {}
    with exact_f32():
        def attn(q, k, v):
            s = sddmm(g, k, q) / math.sqrt(float(d))
            a = edge_softmax(g, s, by="dst")
            a = torch.where(g.edge_mask, a, 0.0)
            return vector_spmm(g.reverse(), a[g.csc_perm.long()], v)

        y = attn(q, k, v)
        grads = common.sq_grad(attn)(*(t.clone().requires_grad_()
                                       for t in (q, k, v)))
        bg = block_graph(g)
        yb = bg.gather_nodes(block_attention(
            bg, bg.scatter_nodes(q), bg.scatter_nodes(k),
            bg.scatter_nodes(v), normalize="dst"))
        checks["attention_vs_dense_block"] = (
            close(y, yb) <= 0 and all(bool(torch.isfinite(t).all())
                                      for t in grads))

        ed = torch.from_numpy(rng.uniform(size=g.num_edges_padded).astype(
            np.float32)).to(device)
        y_xla = vector_spmm(g, ed, q, impl="xla")
        checks["auto_is_dense_block"] = (
            dispatch.resolve(g, "auto") == "dense_block"
            and close(vector_spmm(g, ed, q, impl="auto"), y_xla) <= 0)
        checks["pallas_reaches_k1"] = reaches_k1(g, q, k)

        se, de = ell_dual(g)
        w = ell_pack_weights(se, de, ed)
        checks["packed_spmm"] = close(ell_spmm(se, de, w, q), y_xla[:n]) <= 0

    data = planted_partition(num_classes=4, nodes_per_class=200, seed=0)
    model = GAT(hidden_dim=32, out_dim=4, num_heads=2, num_layers=2,
                in_dim=data.features.shape[1],
                generator=torch.Generator().manual_seed(0))
    _, metrics = fit_full_graph(model, data, epochs=30, seed=0,
                                device=device)
    checks["gat_training"] = metrics["val_acc"] > MIN_VAL_ACC
    for name, ok in checks.items():
        print(f"{name}: {'OK' if ok else 'FAILED'}", flush=True)
    return dict(device=common.where(device), checks=checks,
                val_acc=metrics["val_acc"], ok=all(checks.values()))


def main(argv=None) -> int:
    return common.run_main("verify_story", __doc__, run, argv)


if __name__ == "__main__":
    sys.exit(main())
