"""The op family on the ELL (degree-bucketed) layout — general graphs.

Counterpart of custom_op_benchmark_tpu/ops/ell.py, with the same semantic
contracts as ops/primitives.py:

- **never scatter**: node outputs are assembled by gathering per-bucket row
  contributions through ``row_pos``, canonical edge outputs through
  ``edge_pos``; every sweep writes row-owned outputs, so results repeat
  bit for bit;
- segment reductions (softmax max and sum) are dense masked reductions over
  each bucket's width axis, with the −1e30 mask, the 1e-30 denominator
  floor and the row max a constant of the VJP (detached);
- the backward passes run the forward sweeps over the transpose packing;
  per-slot values cross between the two packings with one gather through
  ``twin_slot`` (:func:`ell_cross_packed`);
- the fused attentions keep α (and GAT's LeakyReLU sign) as the forward's
  residual; the gathered ``(R, D, h, d)`` tiles are made one bucket at a
  time and never saved (the GAT attention on the card makes none).

Every op is a ``torch.autograd.Function`` with the reference's hand VJP;
its forward and backward run inside the spans ``ell.<op>.fwd`` and
``ell.<op>.bwd`` (``utils.spans``; ``ell_gat_attention`` →
``ell.gat_attention``).
Heads are per-head einsums on ``(R, D, h, d)`` views: the reference's
block-indicator matmuls, its optimisation-barrier hop and its lane tiling
of narrow gathers change only how XLA lowers the code on a TPU, so they
are left out. The copy-sum sweep is the CUDA kernel S3
(ops/kernels/gather_sum.py), forward and backward, one launch over all
buckets of a packing; the GAT attention's three sweeps are the CUDA
kernels of ops/kernels/ell_gat.py on CUDA tensors (its plain torch runs on
CPU tensors); the other ops are plain torch, as they are plain XLA in the
reference.

Internally node tensors are ``(n, h, d)`` and per-edge scores and weights
``(E, h)``; the public functions take the reference's ranks, ``(n, d)``
with ``(E,)`` for one head, and return them.

Dtypes follow the reference's ``preferred_element_type=float32``: every op
takes bfloat16 (or float32) operands, forms its products and sums in f32
(the operands are widened with ``.float()``, which is exact, so a product
of two bf16 values is exact) and rounds to the input's dtype only where
the reference calls ``.astype``: at each op's outputs, and inside the GAT
backward where its ``dz`` terms are rounded before they are added. The
fused attentions' α, scores and per-slot cotangents stay f32 between
their sweeps, as in the reference; S3 reads bf16 and sums in f32. The
standalone ``ell_softmax`` is the exception, as in the reference, whose
code for it promotes nothing: forward and backward run in the input's
dtype.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
from torch.autograd import Function

from custom_op_benchmark_tpu_torch.graph.ell import (
    TRAIN_WIDTHS,
    EllGraph,
    ell_pack,
)
from custom_op_benchmark_tpu_torch.graph.graph import Graph
from custom_op_benchmark_tpu_torch.ops.kernels import ell_gat
from custom_op_benchmark_tpu_torch.ops.kernels._build import on_cpu
from custom_op_benchmark_tpu_torch.ops.kernels.gather_sum import gather_sum
from custom_op_benchmark_tpu_torch.utils.spans import spanned

MASK_VALUE = -1e30
DENOM_FLOOR = 1e-30


def ell_dual(g: Graph, profile: str = None,
             **kw) -> Tuple[EllGraph, EllGraph]:
    """(out-edge packing, in-edge packing) sharing canonical edge ids, on
    the graph's device.

    Each packing carries ``twin_slot``, the slot→slot map into the other
    packing, so backward passes move packed edge tensors with one gather.
    ``profile="train"`` selects the finer bucket ladder
    (graph/ell.TRAIN_WIDTHS), which pads less; the default is the pow-2
    ladder.
    """
    if profile is not None:
        if profile != "train":
            raise ValueError(f"profile must be None or 'train', "
                             f"got {profile!r}")
        kw.setdefault("widths", TRAIN_WIDTHS)
    host = g if g.device.type == "cpu" else g.to("cpu")
    se = ell_pack(host, direction="src", **kw)
    de = ell_pack(host, direction="dst", **kw)

    def twin(me: EllGraph, other: EllGraph) -> EllGraph:
        other_pos = other.edge_pos.numpy()
        e_pad = me.num_edges_padded
        maps = []
        for b in me.buckets:
            eid = b.eid.numpy()
            t = np.where(eid < e_pad,
                         other_pos[np.minimum(eid, e_pad - 1)],
                         other.total_slots).astype(np.int32)
            maps.append(torch.from_numpy(t))
        return dataclasses.replace(me, twin_slot=maps)

    pair = (twin(se, de), twin(de, se))
    if host is g:
        return pair
    return tuple(p.to(g.device) for p in pair)


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """(m, ...) → (rows, ...) with zero rows appended."""
    extra = rows - x.shape[0]
    if extra <= 0:
        return x
    return torch.cat([x, x.new_zeros((extra,) + tuple(x.shape[1:]))])


def _pad_nodes(x, n):
    """(n, ...) → (n+1, ...): the zero row the pad column n reads."""
    return _pad_rows(x, n + 1)


def _pad_edges(x, e_slot):
    """(E, ...) → (e_slot + 1, ...): the zero row the pad eid reads."""
    return _pad_rows(x, e_slot + 1)


# ---------------------------------------------------------------------------
# Packed-layout plumbing (all gathers)
# ---------------------------------------------------------------------------

def ell_scatter_edges(ell: EllGraph, x: torch.Tensor) -> List[torch.Tensor]:
    """Canonical (E_pad, ...) → per-bucket packed (R, D, ...) list."""
    xp = _pad_edges(x, ell.num_edges_padded)
    return [xp[b.eid.long()] for b in ell.buckets]


def _flat(packed: List[torch.Tensor]) -> torch.Tensor:
    """Per-bucket (R, D, ...) list → their concatenated (S, ...) slots and
    one zero slot after them."""
    trail = tuple(packed[0].shape[2:])
    return torch.cat([p.reshape((-1,) + trail) for p in packed]
                     + [packed[0].new_zeros((1,) + trail)])


def ell_gather_edges(ell: EllGraph,
                     packed: List[torch.Tensor]) -> torch.Tensor:
    """Per-bucket packed list → canonical (E_pad, ...) through edge_pos."""
    return _flat(packed)[ell.edge_pos.long()]


def ell_cross_packed(src_packing: EllGraph, dst_packing: EllGraph,
                     packed: List[torch.Tensor]) -> List[torch.Tensor]:
    """Per-slot values in ``src_packing``'s layout → ``dst_packing``'s, with
    one gather through ``dst_packing.twin_slot`` (or a canonical round
    trip when the packings were not built by :func:`ell_dual`)."""
    if dst_packing.twin_slot is not None:
        flat = _flat(packed)
        return [flat[t.long()] for t in dst_packing.twin_slot]
    return ell_scatter_edges(dst_packing, ell_gather_edges(src_packing, packed))


def ell_combine_rows(ell: EllGraph,
                     contribs: List[torch.Tensor]) -> torch.Tensor:
    """Per-bucket (R, ...) row contributions → (n_nodes, ...) via row_pos;
    zero-degree nodes read the appended zeros row."""
    trail = tuple(contribs[0].shape[1:])
    cat = torch.cat(contribs + [contribs[0].new_zeros((1,) + trail)])
    return cat[ell.row_pos.long()]


def _nodes3(x: torch.Tensor, name: str):
    """(n, d) → (n, 1, d) and True; (n, h, d) unchanged and False."""
    if x.dim() == 2:
        return x[:, None], True
    if x.dim() == 3:
        return x, False
    raise ValueError(f"{name} must be (n, d) or (n, h, d), got "
                     f"{tuple(x.shape)}")


def _edges2(x: torch.Tensor, e_slot: int) -> torch.Tensor:
    """(E,) → (E, 1); (E, h) unchanged; both padded to ``e_slot`` rows."""
    x = x[:, None] if x.dim() == 1 else x
    return _pad_rows(x, e_slot)


def _f32(*ts: torch.Tensor):
    """The tensors widened to float32 (no copy for float32 ones)."""
    return tuple(t.float() for t in ts)


def _masked_softmax(s: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Softmax of s (R, D, h) over the slots where ``valid`` (R, D) holds;
    a row with no valid slot gives zeros."""
    mask = valid[:, :, None]
    sm = torch.where(mask, s, MASK_VALUE)
    m = sm.amax(1, keepdim=True).detach()
    z = torch.where(mask, torch.exp(sm - m), 0.0)
    return z / z.sum(1, keepdim=True).clamp(min=DENOM_FLOOR)


# ---------------------------------------------------------------------------
# Raw bucket sweeps (shared by forwards and backwards); x is (n, h, d),
# per-slot weights and scores (R, D, h). The packed sweeps compute and
# return f32; the raw ones round to their node input's dtype.
# ---------------------------------------------------------------------------

def _spmm_packed(eg: EllGraph, w_packed, x3):
    """contrib[r] = Σ_k w[r, k] · x[cols[r, k]] per bucket, (R, h, d), f32."""
    xp = _pad_nodes(x3.float(), eg.n_nodes)
    return [torch.einsum("rkh,rkhd->rhd", w.float(), xp[b.cols.long()])
            for b, w in zip(eg.buckets, w_packed)]


def _sddmm_packed(eg: EllGraph, A3, B3):
    """s[r, k] = <A[rows[r]], B[cols[r, k]]> per bucket and head, f32."""
    Ap, Bp = (_pad_nodes(t, eg.n_nodes) for t in _f32(A3, B3))
    return [torch.einsum("rhd,rkhd->rkh", Ap[b.rows.long()],
                         Bp[b.cols.long()]) for b in eg.buckets]


def _spmm_raw(eg: EllGraph, e2, x3):
    if not eg.buckets:           # edgeless graph: the oracle's zeros
        return x3.new_zeros((eg.n_nodes,) + tuple(x3.shape[1:]))
    return ell_combine_rows(eg, _spmm_packed(eg, ell_scatter_edges(eg, e2),
                                             x3)).to(x3.dtype)


def _sddmm_raw(eg: EllGraph, A3, B3):
    if not eg.buckets:
        return A3.new_zeros((eg.num_edges_padded, A3.shape[1]))
    return ell_gather_edges(eg, _sddmm_packed(eg, A3, B3)).to(A3.dtype)


# ---------------------------------------------------------------------------
# ell_spmm, ell_sddmm, ell_softmax
# ---------------------------------------------------------------------------

class _EllSpmm(Function):
    @staticmethod
    @spanned("ell.spmm.fwd")
    def forward(ctx, se, de, e2, x3):
        ctx.graphs = (se, de)
        ctx.save_for_backward(e2, x3)
        return _spmm_raw(se, e2, x3)

    @staticmethod
    @spanned("ell.spmm.bwd")
    def backward(ctx, dy):
        se, de = ctx.graphs
        e2, x3 = ctx.saved_tensors
        de2 = dx = None
        if ctx.needs_input_grad[2]:
            de2 = _sddmm_raw(se, dy, x3)[: e2.shape[0]].to(e2.dtype)
        if ctx.needs_input_grad[3]:
            dx = _spmm_raw(de, e2, dy)[: x3.shape[0]].to(x3.dtype)
        return None, None, de2, dx


class _EllSddmm(Function):
    @staticmethod
    @spanned("ell.sddmm.fwd")
    def forward(ctx, se, de, A3, B3):
        ctx.graphs = (se, de)
        ctx.save_for_backward(A3, B3)
        return _sddmm_raw(se, A3, B3)

    @staticmethod
    @spanned("ell.sddmm.bwd")
    def backward(ctx, dy):
        se, de = ctx.graphs
        A3, B3 = ctx.saved_tensors
        dA = dB = None
        if ctx.needs_input_grad[2]:
            dA = _spmm_raw(se, dy, B3)[: A3.shape[0]].to(A3.dtype)
        if ctx.needs_input_grad[3]:
            dB = _spmm_raw(de, dy, A3)[: B3.shape[0]].to(B3.dtype)
        return None, None, dA, dB


class _EllSoftmax(Function):
    @staticmethod
    @spanned("ell.softmax.fwd")
    def forward(ctx, ell, x2):
        ctx.ell = ell
        if not ell.buckets:
            y = torch.zeros_like(x2)
        else:
            y = ell_gather_edges(ell, [
                _masked_softmax(s, b.cols < ell.n_nodes)
                for b, s in zip(ell.buckets, ell_scatter_edges(ell, x2))])
        ctx.save_for_backward(y)
        return y

    @staticmethod
    @spanned("ell.softmax.bwd")
    def backward(ctx, dy):
        ell = ctx.ell
        (y,) = ctx.saved_tensors
        if not ell.buckets:
            return None, torch.zeros_like(y)
        outs = []
        for yb, dyb in zip(ell_scatter_edges(ell, y),
                           ell_scatter_edges(ell, dy)):
            agg = (yb * dyb).sum(1, keepdim=True)
            outs.append(yb * (dyb - agg))
        return None, ell_gather_edges(ell, outs)[: y.shape[0]]


def ell_spmm(src_ell: EllGraph, dst_ell: EllGraph, edata, x):
    """``y[u] = Σ_{e=(u,v)} edata[e]·x[v]``, the reference's vector_spmm on
    the ELL layout; returns ``(n_nodes, ...)``.

    edata: (E,) with x (n, d), or (E, h) with x (n, h), in canonical order —
    or a :class:`PackedEdgeWeights` from :func:`ell_pack_weights`, whose
    gradient comes back packed in both layouts.
    """
    if isinstance(edata, PackedEdgeWeights):
        return _ell_spmm_packed(src_ell, dst_ell, edata, x)
    x3, squeeze = _nodes3(x, "x")
    if (edata.dim() == 1) != squeeze:
        raise ValueError(f"edata/x head-rank mismatch: {tuple(edata.shape)} "
                         f"vs {tuple(x.shape)}")
    e2 = _edges2(edata, src_ell.num_edges_padded)
    y = _EllSpmm.apply(src_ell, dst_ell, e2, x3)
    return y[:, 0] if squeeze else y


def ell_sddmm(src_ell: EllGraph, dst_ell: EllGraph, A, B):
    """``score[e] = <A[src(e)], B[dst(e)]>`` on the ELL layout; returns
    (E_pad,) or (E_pad, h)."""
    A3, squeeze = _nodes3(A, "A")
    B3, _ = _nodes3(B, "B")
    if A3.shape[1:] != B3.shape[1:]:
        raise ValueError(f"A/B shape mismatch: {tuple(A.shape)} vs "
                         f"{tuple(B.shape)}")
    s = _EllSddmm.apply(src_ell, dst_ell, A3, B3)
    return s[:, 0] if squeeze else s


def ell_softmax(ell: EllGraph, x):
    """Stable segment softmax over ``ell.direction`` segments: a dense
    masked softmax per packed row; its VJP ``dx = y⊙(dy − Σ_seg y·dy)`` is
    dense per row too. x: (E,) or (E, h) canonical; returns (E_pad[, h])."""
    y = _EllSoftmax.apply(ell, _edges2(x, ell.num_edges_padded))
    return y[:, 0] if x.dim() == 1 else y


# ---------------------------------------------------------------------------
# Packed-weight SpMM: edge weights resident in both packings' slot order
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PackedEdgeWeights:
    """Edge weights in BOTH ELL packings' slot order.

    ``src[i]`` has the src packing's bucket-i shape (R, D) or (R, D, h) (or
    (R, D, d) for edge features), ``dst[i]`` likewise for the dst packing;
    the two carry the same per-edge values. The ops that take them return
    a cotangent for each copy. To train them, set ``requires_grad`` on the
    tensors of both lists and read their ``.grad``.
    """

    src: List[torch.Tensor]
    dst: List[torch.Tensor]


def ell_pack_weights(src_ell: EllGraph, dst_ell: EllGraph,
                     edata) -> PackedEdgeWeights:
    """Canonical (E, ...) weights → the dual packed layout (cold path)."""
    e_slot = src_ell.num_edges_padded
    edata = _pad_rows(edata, e_slot)
    return PackedEdgeWeights(src=ell_scatter_edges(src_ell, edata),
                             dst=ell_scatter_edges(dst_ell, edata))


def ell_unpack_weights(src_ell: EllGraph, w: PackedEdgeWeights):
    """Packed → canonical (E_pad, ...) order, through the src copy."""
    return ell_gather_edges(src_ell, w.src)


def _w3(w: torch.Tensor) -> torch.Tensor:
    return w[..., None] if w.dim() == 2 else w


def _spmm_sddmm_fused(eg: EllGraph, w_packed, a3, b3, want_spmm: bool):
    """Per bucket, with one gather of ``b`` through cols:
    ``spmm[r] = Σ_k w[r,k]·b[cols[r,k]]`` (when ``want_spmm``) and
    ``score[r,k] = <a[rows[r]], b[cols[r,k]]>``, both f32."""
    ap, bp = (_pad_nodes(t, eg.n_nodes) for t in _f32(a3, b3))
    spmms, scores = [], []
    for b, w in zip(eg.buckets, w_packed):
        bg = bp[b.cols.long()]                     # (R, D, h, d)
        if want_spmm:
            spmms.append(torch.einsum("rkh,rkhd->rhd", w.float(), bg))
        scores.append(torch.einsum("rhd,rkhd->rkh", ap[b.rows.long()], bg))
    return spmms, scores


class _EllSpmmPacked(Function):
    @staticmethod
    @spanned("ell.spmm.fwd")
    def forward(ctx, se, de, n_src, x3, *ws):
        ctx.graphs, ctx.n_src = (se, de), n_src
        ctx.save_for_backward(x3, *ws)
        if not se.buckets:
            return x3.new_zeros((se.n_nodes,) + tuple(x3.shape[1:]))
        w3 = [_w3(w) for w in ws[:n_src]]
        return ell_combine_rows(se, _spmm_packed(se, w3, x3)).to(x3.dtype)

    @staticmethod
    @spanned("ell.spmm.bwd")
    def backward(ctx, dy):
        """Two gather passes; the cotangents stay packed. dst pass: one dy
        gather per bucket gives ``dx[v] = Σ w·dy[u]`` and ``dW_dst[r,k] =
        <x[rows], dy[cols]>``; src pass: one x gather gives ``dW_src[r,k]
        = <dy[rows], x[cols]>``."""
        se, de = ctx.graphs
        x3, *ws = ctx.saved_tensors
        n_src = ctx.n_src
        if not se.buckets:
            return (None, None, None, torch.zeros_like(x3),
                    *[torch.zeros_like(w) for w in ws])
        w_src = [_w3(w) for w in ws[:n_src]]
        w_dst = [_w3(w) for w in ws[n_src:]]
        dx_c, dw_dst = _spmm_sddmm_fused(de, w_dst, x3, dy, True)
        dx = ell_combine_rows(de, dx_c)[: x3.shape[0]].to(x3.dtype)
        _, dw_src = _spmm_sddmm_fused(se, w_src, dy, x3, False)
        dws = [g.reshape(w.shape).to(w.dtype)
               for g, w in zip(dw_src + dw_dst, ws)]
        return (None, None, None, dx, *dws)


def _ell_spmm_packed(se, de, w: PackedEdgeWeights, x):
    x3, squeeze = _nodes3(x, "x")
    y = _EllSpmmPacked.apply(se, de, len(w.src), x3, *w.src, *w.dst)
    y = y[: x.shape[0]]
    return y[:, 0] if squeeze else y


# ---------------------------------------------------------------------------
# Fused attention (and edge-bias attention): no canonical edge tensors in
# the forward pass
# ---------------------------------------------------------------------------

def _attn_fwd(ell, q3, k3, v3, scale, be_packed=None):
    """One sweep over the normalisation-direction packing ``ell``:
    ``score = (<q[row], k[col]> [+ <q[col], be[slot]>])·scale``, α the
    masked softmax over the row, ``out[row] = Σ α·v[col]``, all in f32.
    Returns (out (n_nodes, h, d), per-bucket α (R, D, h)), both f32."""
    n = ell.n_nodes
    qp, kp, vp = (_pad_nodes(t, n) for t in _f32(q3, k3, v3))
    outs, alphas = [], []
    for i, b in enumerate(ell.buckets):
        cols = b.cols.long()
        s = torch.einsum("rhd,rkhd->rkh", qp[b.rows.long()], kp[cols])
        if be_packed is not None:
            s = s + torch.einsum("rkhd,rkd->rkh", qp[cols],
                                 be_packed[i].float())
        alpha = _masked_softmax(s * scale, b.cols < n)
        outs.append(torch.einsum("rkh,rkhd->rhd", alpha, vp[cols]))
        alphas.append(alpha)
    return ell_combine_rows(ell, outs), alphas


def _attn_bwd(ell, ell_t, q3, k3, v3, scale, alphas, dy, be_t=None):
    """The flash-style backward. Pass 1 on ``ell``: α from the residual,
    ``dS = α(dα − Σ α·dα)·scale`` and ``dq[row] = Σ dS·k[col]``; α and dS
    cross to the transpose packing ``ell_t`` through the twin hop. Pass 2
    on ``ell_t``: ``dk[row] = Σ dS·q[col]``, ``dv[row] = Σ α·dy[col]``,
    and with edge bias ``dq[row] += Σ dS·be`` and ``dbe[slot] = Σ_h
    dS·q[row]`` (``be_t``: the bias in ``ell_t``'s layout). Returns (dq,
    dk, dv, dbe per ``ell_t`` bucket or None), all f32."""
    n = ell.n_nodes
    h = alphas[0].shape[-1]
    qp, kp, vp, dyp = (_pad_nodes(t, n) for t in _f32(q3, k3, v3, dy))
    dq_c, both = [], []
    for b, alpha in zip(ell.buckets, alphas):
        cols = b.cols.long()
        dalpha = torch.einsum("rhd,rkhd->rkh", dyp[b.rows.long()], vp[cols])
        agg = (alpha * dalpha).sum(1, keepdim=True)
        dS = alpha * (dalpha - agg) * scale
        dq_c.append(torch.einsum("rkh,rkhd->rhd", dS, kp[cols]))
        both.append(torch.cat([alpha, dS], -1))          # (R, D, 2h)
    dq = ell_combine_rows(ell, dq_c)[: q3.shape[0]]
    del dq_c
    both_t = ell_cross_packed(ell, ell_t, both)
    del both
    dk_c, dv_c, dqs_c, dbe = [], [], [], []
    for i, (b, bt) in enumerate(zip(ell_t.buckets, both_t)):
        cols = b.cols.long()
        alpha_t, dS_t = bt[..., :h], bt[..., h:]
        dk_c.append(torch.einsum("rkh,rkhd->rhd", dS_t, qp[cols]))
        dv_c.append(torch.einsum("rkh,rkhd->rhd", alpha_t, dyp[cols]))
        if be_t is not None:
            dqs_c.append(torch.einsum("rkh,rkd->rhd", dS_t,
                                      be_t[i].float()))
            dbe.append(torch.einsum("rkh,rhd->rkd", dS_t,
                                    qp[b.rows.long()]))
    dk = ell_combine_rows(ell_t, dk_c)[: k3.shape[0]]
    dv = ell_combine_rows(ell_t, dv_c)[: v3.shape[0]]
    if be_t is None:
        return dq, dk, dv, None
    return dq + ell_combine_rows(ell_t, dqs_c)[: q3.shape[0]], dk, dv, dbe


class _EllAttention(Function):
    @staticmethod
    @spanned("ell.attention.fwd")
    def forward(ctx, ell, ell_t, q3, k3, v3, scale):
        ctx.graphs, ctx.scale = (ell, ell_t), scale
        if not ell.buckets:
            ctx.save_for_backward(q3, k3, v3)
            return torch.zeros_like(q3)
        y, alphas = _attn_fwd(ell, q3, k3, v3, scale)
        ctx.save_for_backward(q3, k3, v3, *alphas)
        return y[: q3.shape[0]].to(q3.dtype)

    @staticmethod
    @spanned("ell.attention.bwd")
    def backward(ctx, dy):
        ell, ell_t = ctx.graphs
        q3, k3, v3, *alphas = ctx.saved_tensors
        if not ell.buckets:
            return (None, None, torch.zeros_like(q3), torch.zeros_like(k3),
                    torch.zeros_like(v3), None)
        dq, dk, dv, _ = _attn_bwd(ell, ell_t, q3, k3, v3, ctx.scale, alphas,
                                  dy)
        return (None, None, dq.to(q3.dtype), dk.to(k3.dtype),
                dv.to(v3.dtype), None)


class _EllEdgeBiasAttention(Function):
    """``packed`` False: ``bes`` is the canonical (E_pad, d) bias. True:
    ``bes`` is the bias packed per src bucket (``n_src`` of them) then per
    dst bucket, and the gradient comes back for both copies."""

    @staticmethod
    @spanned("ell.edge_bias_attention.fwd")
    def forward(ctx, ell, ell_t, q3, k3, v3, scale, packed, n_src, *bes):
        ctx.graphs, ctx.scale = (ell, ell_t), scale
        ctx.packed, ctx.n_src = packed, n_src
        if not ell.buckets:
            ctx.save_for_backward(q3, k3, v3, *bes)
            return torch.zeros_like(q3)
        be_dst = bes[n_src:] if packed else ell_scatter_edges(ell, bes[0])
        y, alphas = _attn_fwd(ell, q3, k3, v3, scale, be_dst)
        ctx.n_alpha = len(alphas)
        ctx.save_for_backward(q3, k3, v3, *bes, *alphas)
        return y[: q3.shape[0]].to(q3.dtype)

    @staticmethod
    @spanned("ell.edge_bias_attention.bwd")
    def backward(ctx, dy):
        ell, ell_t = ctx.graphs
        q3, k3, v3, *rest = ctx.saved_tensors
        if not ell.buckets:
            return (None, None, torch.zeros_like(q3), torch.zeros_like(k3),
                    torch.zeros_like(v3), None, None, None,
                    *[torch.zeros_like(t) for t in rest])
        n_be = len(rest) - ctx.n_alpha
        bes, alphas = rest[:n_be], rest[n_be:]
        be_src = (bes[: ctx.n_src] if ctx.packed
                  else ell_scatter_edges(ell_t, bes[0]))
        dq, dk, dv, dbe = _attn_bwd(ell, ell_t, q3, k3, v3, ctx.scale,
                                    alphas, dy, be_src)
        if ctx.packed:
            # Both cotangent copies; the dst copy rides the twin hop.
            dbes = dbe + ell_cross_packed(ell_t, ell, dbe)
        else:
            dbes = [ell_gather_edges(ell_t, dbe)[: bes[0].shape[0]]]
        dbes = [g.to(b.dtype) for g, b in zip(dbes, bes)]
        return (None, None, dq.to(q3.dtype), dk.to(k3.dtype),
                dv.to(v3.dtype), None, None, None, *dbes)


def _scale(q, scale):
    return 1.0 / (q.shape[-1] ** 0.5) if scale is None else float(scale)


def ell_attention(ell: EllGraph, ell_t: EllGraph, q, k, v, *,
                  scale: float = None):
    """Fused masked attention on the ELL layout: ``out[v] = Σ_{e=(u,v)}
    softmax_v(<q[v], k[u]>·scale)·v[u]`` with ``ell`` the packing of the
    normalisation direction (``"dst"`` for the GNN convention) and
    ``ell_t`` its transpose. q, k, v: (n, d) or (n, h, d)."""
    q3, squeeze = _nodes3(q, "q")
    k3, _ = _nodes3(k, "k")
    v3, _ = _nodes3(v, "v")
    y = _EllAttention.apply(ell, ell_t, q3, k3, v3, _scale(q, scale))
    return y[:, 0] if squeeze else y


def ell_edge_bias_attention(ell: EllGraph, ell_t: EllGraph, q, k, v, be, *,
                            scale: float = None):
    """Fused attention with an edge-carried score bias:

      score[e] = (<k[src], q[dst]> + <q[src], be[e]>)·scale
      out[dst] = Σ softmax_dst(score)·v[src]

    with a gather-only VJP that includes the ``be`` cotangent. ``ell`` is
    the dst packing, ``ell_t`` the src packing; q, k, v: (n, d) or
    (n, h, d); be: (E, d), shared across heads — or a
    :class:`PackedEdgeWeights` of (R, D, d) pieces from
    ``ell_pack_weights(ell_t, ell, be)`` (src copy first), whose
    cotangents come back packed.
    """
    q3, squeeze = _nodes3(q, "q")
    k3, _ = _nodes3(k, "k")
    v3, _ = _nodes3(v, "v")
    sc = _scale(q, scale)
    if isinstance(be, PackedEdgeWeights):
        y = _EllEdgeBiasAttention.apply(ell, ell_t, q3, k3, v3, sc, True,
                                        len(be.src), *be.src, *be.dst)
    else:
        if be.dim() != 2 or be.shape[1] != q3.shape[2]:
            raise ValueError(f"be must be (E, d={q3.shape[2]}), got "
                             f"{tuple(be.shape)}")
        be = _pad_rows(be, ell.num_edges_padded)
        y = _EllEdgeBiasAttention.apply(ell, ell_t, q3, k3, v3, sc, False, 0,
                                        be)
    return y[:, 0] if squeeze else y


# ---------------------------------------------------------------------------
# Unweighted neighbour aggregation (GCN / GraphSAGE / GIN): the kernel S3
# ---------------------------------------------------------------------------

def _copy_agg_raw(eg: EllGraph, x):
    """Copy-SUM per node: one S3 launch over every bucket of the packing's
    cached table, each row's sum written to its node's row and nodes of
    degree 0 zeroed in the same launch (no per-bucket outputs, no row
    combine). Mean is sum/deg in the public op, so the VJP stays a
    transpose copy-sum."""
    return gather_sum(eg.gather_table, x.contiguous())


class _EllCopySum(Function):
    @staticmethod
    @spanned("ell.copy_spmm.fwd")
    def forward(ctx, ell, ell_t, x):
        ctx.ell_t, ctx.n = ell_t, x.shape[0]
        return _copy_agg_raw(ell, x)

    @staticmethod
    @spanned("ell.copy_spmm.bwd")
    def backward(ctx, dy):
        return None, None, _copy_agg_raw(ctx.ell_t, dy)[: ctx.n]


def ell_copy_spmm(ell: EllGraph, ell_t: EllGraph, x, *, reduce: str = "sum"):
    """``out[row] = reduce over the row's neighbours of x[col]``, the
    unweighted aggregation of GCN/GraphSAGE (gspmm copy_lhs). ``mean`` is
    ``sum`` over the degree (so the VJP stays a transpose copy-sum); the
    degree is counted once per packing and cached (``row_degree``)."""
    if reduce not in ("sum", "mean"):
        raise ValueError(f"reduce must be sum/mean, got {reduce!r}")
    y = _EllCopySum.apply(ell, ell_t, x)
    if reduce == "sum":
        return y
    deg = ell.row_degree.to(y.dtype)
    return y / deg.clamp(min=1).reshape((-1,) + (1,) * (y.dim() - 1))


# ---------------------------------------------------------------------------
# NodeMulEdge (edge-carried features)
# ---------------------------------------------------------------------------

class _EllNodeMulEdge(Function):
    @staticmethod
    @spanned("ell.node_mul_edge.fwd")
    def forward(ctx, ell, A3, Be):
        ctx.ell = ell
        ctx.save_for_backward(A3, Be)
        if not ell.buckets:
            return A3.new_zeros((ell.num_edges_padded, A3.shape[1]))
        Ap = _pad_nodes(A3.float(), ell.n_nodes)
        return ell_gather_edges(ell, [
            torch.einsum("rhd,rkd->rkh", Ap[b.rows.long()], beb.float())
            for b, beb in zip(ell.buckets, ell_scatter_edges(ell, Be))
        ]).to(A3.dtype)

    @staticmethod
    @spanned("ell.node_mul_edge.bwd")
    def backward(ctx, dy):
        """Gather-only: both cotangents reduce on the src packing,
        ``dA[u] = Σ_slots dy·Be`` (row combine) and ``dBe[e] = Σ_h
        dy[e, h]·A[src(e), h]`` (edge_pos gather)."""
        ell = ctx.ell
        A3, Be = ctx.saved_tensors
        if not ell.buckets:
            return None, torch.zeros_like(A3), torch.zeros_like(Be)
        Ap = _pad_nodes(A3.float(), ell.n_nodes)
        dA_c, dbe = [], []
        for b, beb, dyb in zip(ell.buckets, ell_scatter_edges(ell, Be),
                               ell_scatter_edges(ell, dy)):
            beb, dyb = _f32(beb, dyb)
            dA_c.append(torch.einsum("rkh,rkd->rhd", dyb, beb))
            dbe.append(torch.einsum("rkh,rhd->rkd", dyb, Ap[b.rows.long()]))
        dA = ell_combine_rows(ell, dA_c)[: A3.shape[0]].to(A3.dtype)
        dBe = ell_gather_edges(ell, dbe)[: Be.shape[0]].to(Be.dtype)
        return None, dA, dBe


def ell_node_mul_edge(ell: EllGraph, ell_t: EllGraph, A, Be):
    """``score[e, h] = <A[src(e), h], Be[e]>`` (Be shared across heads);
    ``ell`` must be the src packing. ``ell_t`` is accepted for symmetry and
    unused: both cotangents reduce on the src packing. Returns (E_pad,) or
    (E_pad, h)."""
    del ell_t
    A3, squeeze = _nodes3(A, "A")
    if Be.dim() != 2 or Be.shape[1] != A3.shape[2]:
        raise ValueError(f"Be must be (E, d={A3.shape[2]}), got "
                         f"{tuple(Be.shape)}")
    s = _EllNodeMulEdge.apply(ell, A3,
                              _pad_rows(Be, ell.num_edges_padded))
    return s[:, 0] if squeeze else s


# ---------------------------------------------------------------------------
# Fused GAT attention
# ---------------------------------------------------------------------------

def _gat_fwd_plain(ell, a_l, a_r, z, slope):
    """The forward on the dst packing in plain torch: (out (n, h, d) in
    z's dtype, per-bucket α, per-bucket LeakyReLU signs). ``a_r`` None:
    no dst term."""
    n = z.shape[0]
    zf, a_lf = _f32(z, a_l)
    zp = _pad_nodes(zf, ell.n_nodes)
    el = torch.einsum("nhd,hd->nh", zp, a_lf)        # (n+1, h)
    er = (None if a_r is None
          else torch.einsum("nhd,hd->nh", zp, a_r.float()))
    outs, alphas, signs = [], [], []
    for b in ell.buckets:
        cols = b.cols.long()
        pre = el[cols]                                   # (R, D, h)
        if er is not None:
            pre = pre + er[b.rows.long()][:, None, :]
        s = torch.where(pre > 0, pre, slope * pre)
        alpha = _masked_softmax(s, b.cols < ell.n_nodes)
        outs.append(torch.einsum("rkh,rkhd->rhd", alpha, zp[cols]))
        alphas.append(alpha)
        signs.append(pre > 0)
    return ell_combine_rows(ell, outs)[:n].to(z.dtype), alphas, signs


def _gat_bwd_plain(ell, ell_t, a_l, a_r, z, alphas, signs, dy, slope):
    """The backward in plain torch: (d_a_l, d_a_r, dz); ``a_r`` None: no
    dst term, and d_a_r None."""
    n, h = z.shape[0], z.shape[1]
    zf, a_lf = _f32(z, a_l)
    zp = _pad_nodes(zf, ell.n_nodes)
    dyp = _pad_nodes(dy.float(), ell.n_nodes)
    der_c, both = [], []
    for b, alpha, sign in zip(ell.buckets, alphas, signs):
        dalpha = torch.einsum("rhd,rkhd->rkh", dyp[b.rows.long()],
                              zp[b.cols.long()])
        agg = (alpha * dalpha).sum(1, keepdim=True)
        dS = alpha * (dalpha - agg)
        dpre = torch.where(sign, dS, slope * dS)
        der_c.append(dpre.sum(1))                    # (R, h)
        both.append(torch.cat([alpha, dpre], -1))    # (R, D, 2h)
    der = ell_combine_rows(ell, der_c)[:n]
    both_t = ell_cross_packed(ell, ell_t, both)
    del both
    dz_c, del_c = [], []
    for b, bt in zip(ell_t.buckets, both_t):
        dz_c.append(torch.einsum("rkh,rkhd->rhd", bt[..., :h],
                                 dyp[b.cols.long()]))
        del_c.append(bt[..., h:].sum(1))
    d_el = ell_combine_rows(ell_t, del_c)[:n]           # (n, h)
    dz_src = (ell_combine_rows(ell_t, dz_c)[:n]
              + d_el[..., None] * a_lf).to(z.dtype)
    d_a_l = torch.einsum("nh,nhd->hd", d_el, zf).to(a_l.dtype)
    if a_r is None:
        return d_a_l, None, dz_src
    dz = (der[..., None] * a_r.float()).to(z.dtype) + dz_src
    d_a_r = torch.einsum("nh,nhd->hd", der, zf).to(a_r.dtype)
    return d_a_l, d_a_r, dz


class _EllGat(Function):
    """On CUDA tensors the three sweeps of ops/kernels/ell_gat.py (z padded
    to the packing's nodes; the residuals α in the dst packing's flat slot
    order, el and er); on CPU tensors the plain torch above (the residuals
    α and the LeakyReLU signs per bucket). ``a_r`` None: no dst term (er
    None) and no a_r cotangent."""

    @staticmethod
    @spanned("ell.gat_attention.fwd")
    def forward(ctx, ell, ell_t, a_l, a_r, z, slope):
        ctx.graphs, ctx.slope, ctx.n = (ell, ell_t), slope, z.shape[0]
        if not ell.buckets:
            ctx.save_for_backward(a_l, a_r, z)
            return torch.zeros_like(z)
        if on_cpu(*(t for t in (a_l, a_r, z, ell.row_pos)
                     if t is not None)):
            out, alphas, signs = _gat_fwd_plain(ell, a_l, a_r, z, slope)
            ctx.n_alpha = len(alphas)
            ctx.save_for_backward(a_l, a_r, z, *alphas, *signs)
            return out
        zk = _pad_rows(z, ell.n_nodes).contiguous()
        out, alpha, el, er = ell_gat.gat_forward(ell, a_l, a_r, zk, slope)
        ctx.save_for_backward(a_l, a_r, zk, alpha, el, er)
        return out[: ctx.n]

    @staticmethod
    @spanned("ell.gat_attention.bwd")
    def backward(ctx, dy):
        """Pass 1 (dst packing): α and the LeakyReLU sign from the
        residuals, ``dpre = LeakyReLU'(pre)·α(dα − Σ α·dα)``, its row sums
        (the er cotangent) and the (α, dpre) stack for the twin hop. Pass 2
        (src packing): ``dz[u] += Σ α·dy[v]`` and the row sums of dpre (the
        el cotangent). The attention vectors' cotangents are node-scale
        contractions of those with z. Sums are f32; as in the reference,
        dz's er term and its src-packing term (α·dy plus the el chain) are
        each rounded to z's dtype before they are added."""
        ell, ell_t = ctx.graphs
        a_l, a_r, z, *rest = ctx.saved_tensors
        if not ell.buckets:
            return (None, None, torch.zeros_like(a_l),
                    None if a_r is None else torch.zeros_like(a_r),
                    torch.zeros_like(z), None)
        if on_cpu(z):
            alphas, signs = rest[: ctx.n_alpha], rest[ctx.n_alpha:]
            grads = _gat_bwd_plain(ell, ell_t, a_l, a_r, z, alphas, signs,
                                   dy, ctx.slope)
            return (None, None, *grads, None)
        alpha, el, er = rest
        dyk = _pad_rows(dy, ell.n_nodes).contiguous()
        ad, der = ell_gat.gat_backward_dst(ell, z, dyk, alpha, el, er,
                                           ctx.slope)
        d_a_l, d_a_r, dz = ell_gat.gat_backward_src(ell_t, a_l, a_r, z, dyk,
                                                    ad, der)
        return None, None, d_a_l, d_a_r, dz[: ctx.n], None


def ell_gat_attention(ell: EllGraph, ell_t: EllGraph, a_l, a_r, z, *,
                      negative_slope: float = 0.2):
    """Fused GAT core on the ELL layout: ``score[e] = LeakyReLU(a_l·z[src]
    + a_r·z[dst])``, α the softmax over the in-edges of dst, ``out[dst] =
    Σ α·z[src]``. ``ell`` is the dst packing, ``ell_t`` the src packing;
    a_l, a_r: (h, d); z: (n, h, d) → (n, h, d). ``a_r`` None leaves the
    dst term out (``score[e] = LeakyReLU(a_l·z[src])``)."""
    if z.dim() != 3 or a_l.shape != z.shape[1:] or (
            a_r is not None and a_r.shape != z.shape[1:]):
        raise ValueError(f"ell_gat_attention wants z (n, h, d) and a_l/a_r "
                         f"(h, d); got {tuple(z.shape)}, {tuple(a_l.shape)},"
                         f" {None if a_r is None else tuple(a_r.shape)}")
    return _EllGat.apply(ell, ell_t, a_l, a_r, z, float(negative_slope))
