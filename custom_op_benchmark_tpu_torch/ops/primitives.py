"""Public differentiable ops: ``torch.autograd.Function`` wiring and shape
dispatch.

Counterpart of custom_op_benchmark_tpu/ops/primitives.py:

- every op of the family is an autograd Function whose backward is the
  hand VJP of the segment oracle (ops/xla.py); index arrays get no
  gradient;
- rank dispatch as in the reference: rank-2 node features mean one head,
  normalised internally to ``(n, h, d)``; edge data is ``(E,)`` or
  ``(E, h)``;
- ``impl`` selects the execution strategy through ops/dispatch.py:
  ``"xla"`` (the segment oracle), ``"tiled"``/``"pallas"`` (the CUDA tile
  kernels on the tile-aligned order), ``"dense_block"`` (the
  component-batched dense layout, ops/dense_block.py), ``"ell"`` (the
  degree-bucketed layout, ops/ell.py) and ``"auto"`` (the strategy
  advisor, utils/summary.py).

Shapes are checked before anything runs, as the reference checks them at
trace time.
"""

from __future__ import annotations

import torch

from custom_op_benchmark_tpu_torch.graph.graph import Graph
from custom_op_benchmark_tpu_torch.ops import dispatch as _dispatch
from custom_op_benchmark_tpu_torch.ops import xla as _xla


def _norm_nodes(x, name):
    if x.dim() == 2:
        return x[:, None, :], True
    if x.dim() == 3:
        return x, False
    raise ValueError(f"{name} must be (n, d) or (n, h, d), got "
                     f"{tuple(x.shape)}")


def _norm_edges(x, name):
    if x.dim() == 1:
        return x[:, None], True
    if x.dim() == 2:
        return x, False
    raise ValueError(f"{name} must be (e,) or (e, h), got {tuple(x.shape)}")


def _check_nodes(g: Graph, x, name):
    if x.shape[0] != g.n_nodes:
        raise ValueError(f"{name} has {x.shape[0]} rows, the graph "
                         f"{g.n_nodes} nodes")


def _check_edges(g: Graph, x, name):
    if x.shape[0] != g.num_edges_padded:
        raise ValueError(f"{name} has {x.shape[0]} rows, the graph "
                         f"{g.num_edges_padded} (padded) edges")


# ---------------------------------------------------------------------------
# The four ops of the family, on the segment oracle
# ---------------------------------------------------------------------------

class _Sddmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, dst, csc_perm, dst_csc, A, B):
        ctx.save_for_backward(src, dst, csc_perm, dst_csc, A, B)
        return _xla.sddmm_fwd(src, dst, A, B)

    @staticmethod
    def backward(ctx, dy):
        src, dst, csc_perm, dst_csc, A, B = ctx.saved_tensors
        dA, dB = _xla.sddmm_bwd(src, dst, csc_perm, dst_csc, A, B, dy)
        return None, None, None, None, dA, dB


class _NodeMulEdge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, A, B):
        ctx.save_for_backward(src, A, B)
        return _xla.node_mul_edge_fwd(src, A, B)

    @staticmethod
    def backward(ctx, dy):
        src, A, B = ctx.saved_tensors
        dA, dB = _xla.node_mul_edge_bwd(src, A, B, dy)
        return None, dA, dB


class _EdgeSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, x, num_segments):
        y = _xla.edge_softmax_fwd(ids, x, num_segments)
        ctx.num_segments = num_segments
        ctx.save_for_backward(ids, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        ids, y = ctx.saved_tensors
        return None, _xla.edge_softmax_bwd(ids, y, dy, ctx.num_segments), None


class _VectorSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, dst, csc_perm, dst_csc, edata, x):
        ctx.save_for_backward(src, dst, csc_perm, dst_csc, edata, x)
        return _xla.vector_spmm_fwd(src, dst, edata, x)

    @staticmethod
    def backward(ctx, dy):
        src, dst, csc_perm, dst_csc, edata, x = ctx.saved_tensors
        dedata, dx = _xla.vector_spmm_bwd(src, dst, csc_perm, dst_csc, edata,
                                          x, dy.contiguous())
        return None, None, None, None, dedata, dx


def sddmm(g: Graph, A: torch.Tensor, B: torch.Tensor, *,
          impl: str = "auto") -> torch.Tensor:
    """Edge scores ``y[e(, h)] = <A[src(e)(, h)], B[dst(e)(, h)]>``.

    A, B: ``(n, d)`` → ``(E,)``; ``(n, h, d)`` → ``(E, h)`` (E = padded
    edge count; padded entries are 0 here and garbage on other strategies).
    """
    strategy = _dispatch.resolve(g, impl)
    A3, sa = _norm_nodes(A, "A")
    B3, sb = _norm_nodes(B, "B")
    if sa != sb or A3.shape != B3.shape:
        raise ValueError(f"A/B shape mismatch: {tuple(A.shape)} vs "
                         f"{tuple(B.shape)}")
    _check_nodes(g, A, "A")
    if strategy != "xla":
        return _dispatch.sddmm(strategy, g, A, B)
    y = _Sddmm.apply(g.src, g.dst, g.csc_perm, g.dst_csc, A3, B3)
    return y[:, 0] if sa else y


def node_mul_edge(g: Graph, A: torch.Tensor, B: torch.Tensor, *,
                  impl: str = "auto") -> torch.Tensor:
    """Edge scores ``y[e(, h)] = <A[src(e)(, h), :], B[e, :]>``; ``B`` is
    edge-carried and shared across heads. The tiled strategy has no kernel
    for it and routes to ELL, as in the reference."""
    strategy = _dispatch.resolve(g, impl)
    A3, squeeze = _norm_nodes(A, "A")
    if B.dim() != 2 or B.shape[1] != A3.shape[2]:
        raise ValueError(f"B must be (e, d={A3.shape[2]}), got "
                         f"{tuple(B.shape)}")
    _check_nodes(g, A, "A")
    _check_edges(g, B, "B")
    if strategy == "tiled":
        strategy = "ell"
    if strategy != "xla":
        return _dispatch.node_mul_edge(strategy, g, A, B)
    y = _NodeMulEdge.apply(g.src, A3, B)
    return y[:, 0] if squeeze else y


def edge_softmax(g: Graph, x: torch.Tensor, *, by: str = "dst",
                 impl: str = "auto") -> torch.Tensor:
    """Stable softmax over each node's incident-edge segment: ``by="dst"``
    over in-edges, ``by="src"`` over out-edges. The dst direction runs in
    CSC order and permutes back. Padded edges come back as 0."""
    strategy = _dispatch.resolve(g, impl)
    if by not in ("src", "dst"):
        raise ValueError(f"by must be 'src' or 'dst', got {by!r}")
    x2, squeeze = _norm_edges(x, "x")
    _check_edges(g, x, "x")
    if strategy != "xla":
        return _dispatch.edge_softmax(strategy, g, x, by)
    n = g.n_nodes
    if by == "src":
        y = _EdgeSoftmax.apply(g.src, x2, n)
    else:
        y_csc = _EdgeSoftmax.apply(g.dst_csc, x2[g.csc_perm.long()], n)
        y = y_csc[g.csc_perm_inv.long()]
    return y[:, 0] if squeeze else y


def vector_spmm(g: Graph, edata: torch.Tensor, x: torch.Tensor, *,
                impl: str = "auto") -> torch.Tensor:
    """``out[u(, h)] = Σ_{e=(u,v)} edata[e(, h)] · x[v(, h)]`` over each
    node's out-edges. For in-edge aggregation pass ``g.reverse()`` and
    CSC-permuted ``edata``."""
    strategy = _dispatch.resolve(g, impl)
    x3, sx = _norm_nodes(x, "x")
    e2, se = _norm_edges(edata, "edata")
    if se != sx:
        raise ValueError(f"edata/x head-rank mismatch: {tuple(edata.shape)} "
                         f"vs {tuple(x.shape)}")
    if e2.shape[1] != x3.shape[1]:
        raise ValueError(f"edata heads {e2.shape[1]} != x heads "
                         f"{x3.shape[1]}")
    _check_nodes(g, x, "x")
    _check_edges(g, edata, "edata")
    if strategy != "xla":
        return _dispatch.vector_spmm(strategy, g, edata, x)
    y = _VectorSpmm.apply(g.src, g.dst, g.csc_perm, g.dst_csc, e2, x3)
    return y[:, 0, :] if sx else y


def softmax_aggregate_dst(g: Graph, scores: torch.Tensor, x: torch.Tensor, *,
                          dropout_fn=None, impl: str = "auto"):
    """``edge_softmax(by="dst")`` and in-edge aggregation, staying in CSC
    order: ``out[v] = Σ_{e=(u,v)} softmax_dst(scores)[e] · x[u]``.

    scores: (E,) or (E, h) in canonical order; x: (n, d) or (n, h, d).
    ``dropout_fn`` (optional) is applied to α in CSC order. This is the
    segment path whatever ``impl`` says, as in the reference.
    """
    del impl
    s2, ssq = _norm_edges(scores, "scores")
    _check_edges(g, scores, "scores")
    n = g.n_nodes
    a_csc = _EdgeSoftmax.apply(g.dst_csc, s2[g.csc_perm.long()], n)
    a_csc = torch.where((g.dst_csc < n)[:, None], a_csc, 0.0)
    if dropout_fn is not None:
        a_csc = dropout_fn(a_csc)
    a_csc = a_csc[:, 0] if ssq else a_csc
    return vector_spmm(g.reverse(), a_csc, x, impl="xla")


# ---------------------------------------------------------------------------
# Generalised message passing (gSDDMM / gSpMM): gathers by endpoint and
# sorted segment sums with hand VJPs (ops/xla.py), no atomics
# ---------------------------------------------------------------------------

_BINARY = {
    "mul": lambda a, b: a * b,
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "div": lambda a, b: a / b,
    "dot": lambda a, b: (a * b).sum(-1, keepdim=True),
    "copy_lhs": lambda a, b: a,
    "copy_rhs": lambda a, b: b,
}


def _edge_operand(g: Graph, x, target: str):
    if target == "u":
        return _xla.gather_rows(g, x, "src")
    if target == "v":
        return _xla.gather_rows(g, x, "dst")
    if target == "e":
        return x
    raise ValueError(f"target must be u/v/e, got {target!r}")


def gsddmm(g: Graph, op: str, lhs, rhs=None, *, lhs_target="u",
           rhs_target="v"):
    """Generalised SDDMM: per-edge ``op(lhs[target], rhs[target])``."""
    a = _edge_operand(g, lhs, lhs_target)
    if rhs is None:
        return a
    return _BINARY[op](a, _edge_operand(g, rhs, rhs_target))


def gspmm(g: Graph, op: str, reduce: str, lhs=None, rhs=None, *,
          lhs_target="e", rhs_target="v", to: str = "src"):
    """Generalised SpMM: reduce per-edge messages into node segments,
    ``to="src"`` over out-edges, ``to="dst"`` over in-edges (CSC order).
    ``reduce`` is sum, mean, max or min; an empty segment's max is -1e9
    (its min +1e9)."""
    if lhs is None and rhs is None:
        raise ValueError("need at least one operand")
    if reduce not in ("sum", "mean", "max", "min"):
        raise ValueError(f"reduce must be sum/mean/max/min, got {reduce!r}")
    if to not in ("src", "dst"):
        raise ValueError(f"to must be 'src' or 'dst', got {to!r}")
    n = g.n_nodes
    operands = [(x, t) for x, t in ((lhs, lhs_target), (rhs, rhs_target))
                if x is not None]
    if len(operands) == 2 and op == "copy_lhs":
        operands = operands[:1]
    elif len(operands) == 2 and op == "copy_rhs":
        operands = operands[1:]
    frm = {"u": "src", "v": "dst"}.get(operands[0][1])
    if (len(operands) == 1 and reduce in ("sum", "mean") and frm is not None
            and frm != to):
        # A node feature copied along each edge and summed at the other
        # end: one CSR sum, with no (E, d) message in memory.
        s = _xla.copy_sum(g, operands[0][0], frm, to)
    else:
        msg = _edge_operand(g, *operands[0])
        if len(operands) == 2:
            msg = _BINARY[op](msg, _edge_operand(g, *operands[1]))
        if reduce in ("max", "min"):
            ids = g.src if to == "src" else g.dst_csc
            if to == "dst":
                msg = msg[g.csc_perm.long()]
            if reduce == "max":
                return _xla.segment_max(msg, ids, n)
            return -_xla.segment_max(-msg, ids, n)
        s = _xla.sorted_segment_sum(g, msg, to)
    if reduce == "sum":
        return s
    ptr = g.indptr_r if to == "src" else g.indptr_c
    cnt = torch.diff(ptr[: n + 1]).to(s.dtype).clamp(min=1.0)
    return s / cnt.reshape((n,) + (1,) * (s.dim() - 1))


# ---------------------------------------------------------------------------
# Whole-layer ops with strategy dispatch
# ---------------------------------------------------------------------------

def attention(g: Graph, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              edge_bias: torch.Tensor = None, scale: float = None,
              impl: str = "auto") -> torch.Tensor:
    """Masked attention: ``score[e] = (<q[dst], k[src]> + <q[src],
    edge_bias[e]>)·scale``, softmax over the in-edges of dst, ``out[v] =
    Σ α·v[src]``. q, k, v: (n, d) or (n, h, d); ``edge_bias`` (E, d) is
    shared across heads. With ``edge_bias`` the tiled strategy routes to
    ELL, as in the reference."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    strategy = _dispatch.resolve(g, impl)
    if strategy == "tiled" and edge_bias is not None:
        strategy = "ell"
    if strategy != "xla":
        return _dispatch.attention(strategy, g, q, k, v, float(scale),
                                   edge_bias)
    scores = sddmm(g, k, q, impl="xla")
    if edge_bias is not None:
        scores = scores + node_mul_edge(g, q, edge_bias, impl="xla")
    return softmax_aggregate_dst(g, scores * scale, v)


def gat_attention(g: Graph, a_l: torch.Tensor, a_r: torch.Tensor,
                  z: torch.Tensor, *, negative_slope: float = 0.2,
                  impl: str = "auto") -> torch.Tensor:
    """Additive (GAT) attention: ``score[e] = LeakyReLU(a_l·z[src] +
    a_r·z[dst])``, softmax over the in-edges of dst, ``out[v] = Σ
    α·z[src]``. a_l, a_r: (h, d); z: (n, h, d). The tiled strategy routes
    to ELL, as in the reference."""
    if z.dim() != 3 or a_l.dim() != 2 or a_r.dim() != 2:
        raise ValueError(f"gat_attention wants z (n, h, d) and a_l/a_r "
                         f"(h, d); got {tuple(z.shape)}, {tuple(a_l.shape)},"
                         f" {tuple(a_r.shape)}")
    strategy = _dispatch.resolve(g, impl)
    if strategy == "tiled":
        strategy = "ell"
    if strategy != "xla":
        return _dispatch.gat_attention(strategy, g, a_l, a_r, z,
                                       float(negative_slope))
    el = torch.einsum("nhd,hd->nh", z, a_l)
    er = torch.einsum("nhd,hd->nh", z, a_r)
    s = _xla.gather_rows(g, el, "src") + _xla.gather_rows(g, er, "dst")
    s = torch.nn.functional.leaky_relu(s, negative_slope)
    return softmax_aggregate_dst(g, s, z)
