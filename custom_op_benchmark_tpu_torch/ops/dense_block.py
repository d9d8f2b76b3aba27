"""The op family on the component-batched dense layout (BlockGraph).

Counterpart of custom_op_benchmark_tpu/ops/dense_block.py, with the
semantic contracts of ops/primitives.py, for graphs whose components fit
dense ``(B, L, L)`` blocks. The reference computes these as masked
``einsum``/batched matmuls outside any Pallas kernel, so here they are
``torch.einsum`` (batched GEMMs) and masked reductions, and their
gradients come from autograd.

Products take f32 operands and return the input's dtype: bf16 inputs are
widened, multiplied and summed in f32 and rounded once (the reference's
``preferred_element_type=f32``).

Inputs live block-dense: node tensors ``(B, L, ...)`` via
``bg.scatter_nodes``, edge tensors ``(B, L, L, ...)`` via
``bg.scatter_edges``. Multi-head shapes append ``(h, d)`` / ``(h,)``.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from custom_op_benchmark_tpu_torch.graph.blockdiag import BlockGraph

_NEG = -1e30


def _mm(spec: str, a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """``einsum(spec, a, b)`` on f32 operands, rounded to ``dtype``."""
    return torch.einsum(spec, a.float(), b.float()).to(dtype)


def _adj(bg: BlockGraph, x: torch.Tensor) -> torch.Tensor:
    """The adjacency broadcast against (B, L, L) or (B, L, L, h)."""
    return bg.adj if x.dim() == 3 else bg.adj[..., None]


def block_sddmm(bg: BlockGraph, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Masked scores: a, b (B, L, d) → (B, L, L); or (B, L, h, d) →
    (B, L, L, h)."""
    if a.dim() == 3:
        s = _mm("bxd,byd->bxy", a, b, a.dtype)
    else:
        s = _mm("bxhd,byhd->bxyh", a, b, a.dtype)
    return torch.where(_adj(bg, s), s, 0.0)


def block_node_mul_edge(bg: BlockGraph, a: torch.Tensor,
                        be: torch.Tensor) -> torch.Tensor:
    """scores[b, x, y(, h)] = <a[b, x(, h)], be[b, x, y]>: node × edge
    feature dots (``be`` is edge-carried and shared across heads)."""
    if a.dim() == 3:
        s = _mm("bxd,bxyd->bxy", a, be, a.dtype)
    else:
        s = _mm("bxhd,bxyd->bxyh", a, be, a.dtype)
    return torch.where(_adj(bg, s), s, 0.0)


def block_softmax(bg: BlockGraph, scores: torch.Tensor, *,
                  by: str = "src") -> torch.Tensor:
    """Stable masked softmax over a node's incident edges: ``by="src"``
    over each row's out-edges (axis 2), ``by="dst"`` over each column's
    in-edges (axis 1). The max is a constant of the gradient."""
    if by == "src":
        axis = 2
    elif by == "dst":
        axis = 1
    else:
        raise ValueError(f"by must be 'src' or 'dst', got {by!r}")
    adj = _adj(bg, scores)
    s = torch.where(adj, scores, _NEG)
    m = s.amax(dim=axis, keepdim=True).detach()
    z = torch.where(adj, torch.exp(s - m), 0.0)
    denom = z.sum(dim=axis, keepdim=True)
    return z / denom.clamp(min=1e-30)


def block_spmm(bg: BlockGraph, ed: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """y[b, u] = Σ_v ed[b, u, v]·x[b, v]: out-edge aggregation. ed (B, L, L)
    or (B, L, L, h); x (B, L, d) or (B, L, h, d)."""
    ed = torch.where(_adj(bg, ed), ed, 0.0)
    if ed.dim() == 3:
        return _mm("bxy,byd->bxd", ed, x, x.dtype)
    return _mm("bxyh,byhd->bxhd", ed, x, x.dtype)


def block_copy_spmm(bg: BlockGraph, x: torch.Tensor, *,
                    reduce: str = "sum") -> torch.Tensor:
    """out[b, v] = Σ (or mean) over in-edges u→v of x[b, u]: the unweighted
    aggregation of GCN/GraphSAGE as one masked batched matmul. x (B, L, d).
    """
    out = torch.einsum("bxy,bxd->byd", bg.adj.float(), x.float())
    if reduce == "mean":
        deg = bg.adj.sum(dim=1).float().clamp(min=1.0)
        out = out / deg[..., None]
    elif reduce != "sum":
        raise ValueError(f"reduce must be 'sum'/'mean', got {reduce!r}")
    return out.to(x.dtype)


def block_gat_attention(bg: BlockGraph, a_l: torch.Tensor, a_r: torch.Tensor,
                        z: torch.Tensor, *,
                        negative_slope: float = 0.2) -> torch.Tensor:
    """The GAT layer core: score[b, u, v, h] = LeakyReLU(a_l·z[b, u, h] +
    a_r·z[b, v, h]), α = softmax over the in-edges of dst v, out[b, v, h] =
    Σ_u α·z[b, u, h]. a_l, a_r (h, d); z (B, L, h, d)."""
    el = torch.einsum("blhd,hd->blh", z.float(), a_l.float())
    er = torch.einsum("blhd,hd->blh", z.float(), a_r.float())
    s = el[:, :, None, :] + er[:, None, :, :]        # (B, L, L, h): u, v
    s = F.leaky_relu(s, negative_slope)
    alpha = block_softmax(bg, s.to(z.dtype), by="dst")
    return _mm("bxyh,bxhd->byhd", alpha, z, z.dtype)


def block_attention(bg: BlockGraph, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, *, scale: float = None,
                    normalize: str = "dst") -> torch.Tensor:
    """Masked attention per block: SDDMM → softmax → SpMM.
    ``normalize="dst"`` aggregates over in-edges (the GNN direction);
    ``"src"`` mirrors it. q, k, v (B, L, d) or (B, L, h, d)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if normalize == "dst":
        s = block_sddmm(bg, k, q) * scale    # s[b, u, v] keyed (src, dst)
        alpha = block_softmax(bg, s, by="dst")
        if q.dim() == 3:
            return _mm("bxy,bxd->byd", alpha, v, v.dtype)
        return _mm("bxyh,bxhd->byhd", alpha, v, v.dtype)
    if normalize == "src":
        s = block_sddmm(bg, q, k) * scale
        alpha = block_softmax(bg, s, by="src")
        return block_spmm(bg, alpha, v)
    raise ValueError(f"normalize must be 'src'/'dst', got {normalize!r}")
