"""The ELL attention backward, pass by pass.

Counterpart of scripts/exp_bwd_accounting.py. On ``random_graph(131072,
2M, power_law=True)`` at h = 1, d = 128, f32, it times apart

    fwd_plain         ``ell_attention`` forward with no gradient (no α kept)
    fwd_res           the same forward on inputs that require grad (α saved
                      for the backward)
    pass1             pass 1 on the dst packing from saved α: dq and the
                      packed (α, dS)
    hop               the twin hop of the (α, dS) stack to the src packing
                      (``ell_cross_packed``)
    pass2             pass 2 on the src packing: dk and dv
    pass1+hop+pass2   the three in one call
    grad_total        the gradient of (ell_attention(q, k, v)²).sum()
                      with respect to q, k, v (forward and backward)
    gather_w{c}       a random permutation gather of (S, c) f32 rows, S the
                      dst packing's slots: the hop is such a gather at c = 2

The passes are this driver's own copies of ``ops/ell.py``'s
``_attn_bwd``; the driver holds pass 1 + hop + pass 2 to ``_attn_bwd``'s
dq, dk and dv bit for bit and exits 1 when a copy has drifted.

Runs on the CUDA device, ``--small`` on a 16,384-node, 250,000-edge
graph, or with ``--device cpu`` on 512 nodes and 4,000 edges, timing
nothing.

Run:  python -m custom_op_benchmark_tpu_torch.experiments.exp_bwd_accounting [--small | --device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from custom_op_benchmark_tpu_torch.experiments import common
from custom_op_benchmark_tpu_torch.graph import random_graph
from custom_op_benchmark_tpu_torch.ops import ell_attention, ell_dual
from custom_op_benchmark_tpu_torch.ops.ell import (
    _attn_bwd,
    _attn_fwd,
    _pad_nodes,
    ell_combine_rows,
    ell_cross_packed,
)

D = 128
GATHER_WIDTHS = (1, 2, 4, 16, 128)


def pass1(ell, k3, v3, dy, alphas, scale):
    """Pass 1 on the dst packing ``ell`` (``_attn_bwd``'s first loop): dq
    and the per-bucket (α, dS) stacks (R, D, 2h). k3, v3, dy: (n, h, d)."""
    n = ell.n_nodes
    kp, vp, dyp = (_pad_nodes(t.float(), n) for t in (k3, v3, dy))
    dq_c, both = [], []
    for b, alpha in zip(ell.buckets, alphas):
        cols = b.cols.long()
        dalpha = torch.einsum("rhd,rkhd->rkh", dyp[b.rows.long()], vp[cols])
        agg = (alpha * dalpha).sum(1, keepdim=True)
        dS = alpha * (dalpha - agg) * scale
        dq_c.append(torch.einsum("rkh,rkhd->rhd", dS, kp[cols]))
        both.append(torch.cat([alpha, dS], -1))
    return ell_combine_rows(ell, dq_c)[: k3.shape[0]], both


def hop(ell, ell_t, both):
    """The twin hop: the (α, dS) stacks into ``ell_t``'s layout."""
    return ell_cross_packed(ell, ell_t, both)


def pass2(ell_t, q3, dy, both_t):
    """Pass 2 on the src packing ``ell_t`` (``_attn_bwd``'s second loop):
    dk and dv from the hopped stacks."""
    n = ell_t.n_nodes
    h = both_t[0].shape[-1] // 2
    qp, dyp = (_pad_nodes(t.float(), n) for t in (q3, dy))
    dk_c, dv_c = [], []
    for b, bt in zip(ell_t.buckets, both_t):
        cols = b.cols.long()
        dk_c.append(torch.einsum("rkh,rkhd->rhd", bt[..., h:], qp[cols]))
        dv_c.append(torch.einsum("rkh,rkhd->rhd", bt[..., :h], dyp[cols]))
    m = q3.shape[0]
    return (ell_combine_rows(ell_t, dk_c)[:m],
            ell_combine_rows(ell_t, dv_c)[:m])


def passes(de, se, q3, k3, v3, dy, alphas, scale):
    """dq, dk, dv through pass 1, the hop and pass 2."""
    dq, both = pass1(de, k3, v3, dy, alphas, scale)
    dk, dv = pass2(se, q3, dy, hop(de, se, both))
    return dq, dk, dv


def run(device: torch.device, size: str = "full") -> dict:
    n, e = common.GRAPH[size]
    g = random_graph(n, e, seed=0, power_law=True).to(device)
    se, de = ell_dual(g)
    rng = np.random.default_rng(0)
    q, k, v, dy = (torch.from_numpy(rng.standard_normal(
        (n, D), dtype=np.float32)).to(device) for _ in range(4))
    q3, k3, v3, dy3 = (t[:, None] for t in (q, k, v, dy))
    scale = 1.0 / np.sqrt(D)
    slots = sum(b.cols.numel() for b in de.buckets)
    print(f"n={n} e={g.n_edges} dst slots={slots} "
          f"({slots / g.n_edges:.3f}x)", flush=True)

    with torch.no_grad():
        _, alphas = _attn_fwd(de, q3, k3, v3, scale)
        want = _attn_bwd(de, se, q3, k3, v3, scale, alphas, dy3)[:3]
        got = passes(de, se, q3, k3, v3, dy3, alphas, scale)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"pass 1 + hop + pass 2 equal _attn_bwd's dq, dk, dv bit for "
          f"bit: {same}", flush=True)

    rows = common.Rows(device)
    with torch.no_grad():
        rows("fwd_plain", lambda q, k, v: ell_attention(de, se, q, k, v),
             q, k, v, edges=g.n_edges)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    rows("fwd_res", lambda q, k, v: ell_attention(de, se, q, k, v),
         qg, kg, vg, edges=g.n_edges)
    with torch.no_grad():
        rows("pass1", lambda k, v, dy: pass1(de, k, v, dy, alphas, scale),
             k3, v3, dy3, edges=g.n_edges)
        both = pass1(de, k3, v3, dy3, alphas, scale)[1]
        rows("hop", lambda *bs: hop(de, se, list(bs)), *both,
             edges=g.n_edges)
        both_t = hop(de, se, both)
        rows("pass2", lambda q, dy, *bt: pass2(se, q, dy, list(bt)), q3, dy3,
             *both_t, edges=g.n_edges)
        rows("pass1+hop+pass2", lambda q, k, v, dy: passes(
            de, se, q, k, v, dy, alphas, scale), q3, k3, v3, dy3,
            edges=g.n_edges)
        del both, both_t
    rows("grad_total", common.sq_grad(
        lambda q, k, v: ell_attention(de, se, q, k, v)), qg, kg, vg,
        edges=g.n_edges)

    perm = torch.from_numpy(rng.permutation(slots)).to(device)
    gather_bytes = {}
    with torch.no_grad():
        for c in GATHER_WIDTHS:
            src = torch.from_numpy(rng.standard_normal(
                (slots, c), dtype=np.float32)).to(device)
            rows(f"gather_w{c}", lambda s: s[perm], src)
            gather_bytes[f"gather_w{c}"] = slots * (2 * c * 4 + 8)
    return dict(device=common.where(device), n=n, e=g.n_edges, d=D, h=1,
                dst_slots=slots, pad=slots / g.n_edges, ms=rows.ms,
                gather_bytes=gather_bytes, same_bits=same, ok=same)


def main(argv=None) -> int:
    return common.run_main("exp_bwd_accounting", __doc__, run, argv)


if __name__ == "__main__":
    sys.exit(main())
