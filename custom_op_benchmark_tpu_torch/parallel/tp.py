"""Head parallelism for multi-head graph attention.

Counterpart of custom_op_benchmark_tpu/parallel/tp.py. Heads are
independent through score → softmax → aggregate, so the head axis is the
natural tensor-parallel dimension: q, k, v are split ``(n, h/T, d)`` over
a ``"head"`` axis of size T, every shard holds all nodes, and the
single-device ELL ops run unchanged on each shard's heads (the graph
views describe structure and are replicated). A transformer block needs
one reduction, at its output projection: each shard's partial product,
summed over the head axis in shard order (``psum``).

On the local mesh the T head shards are slices of the same tensors, run
one after the other; on the process mesh each rank holds its own slice
(:func:`shard_heads`).
"""

from __future__ import annotations

import torch

from custom_op_benchmark_tpu_torch.parallel.mesh import Mesh, psum, shard


def head_sharding(mesh: Mesh, axis: str = "head") -> tuple:
    """The spec of ``(n, h, d)`` activations: heads split over ``axis``."""
    return (None, axis)


def shard_heads(mesh: Mesh, x, axis: str = "head"):
    """Place an ``(n, h, d)`` array with its head axis sharded."""
    return shard(mesh, x, head_sharding(mesh, axis))


def _check(mesh: Mesh, axis: str, heads: int) -> int:
    tp = mesh.shape[axis]
    if mesh.is_local and heads % tp:
        raise ValueError(f"heads {heads} not divisible by TP degree {tp}")
    return tp


def _per_shard(mesh: Mesh, axis: str, fn, split, *args):
    """Run ``fn`` on each head shard: ``split[i]`` is the dimension of
    ``args[i]`` that holds heads (None: replicated). The local mesh runs
    the T slices in turn and concatenates them along dimension 1."""
    if not mesh.is_local:
        return [fn(*args)]
    tp = mesh.shape[axis]
    outs = []
    for t in range(tp):
        part = []
        for a, dim in zip(args, split):
            if dim is None:
                part.append(a)
            else:
                hs = a.shape[dim] // tp
                part.append(a.narrow(dim, t * hs, hs))
        outs.append(fn(*part))
    return outs


def tp_attention(ell, ell_t, mesh: Mesh, q, k, v, *, axis: str = "head",
                 scale: float = None):
    """Fused ELL attention with heads sharded over ``axis``. q, k, v:
    ``(n, h, d)`` (the rank's heads on the process mesh) with h divisible
    by the axis size; the output keeps the sharding."""
    from custom_op_benchmark_tpu_torch.ops import ell_attention

    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    _check(mesh, axis, q.shape[1])
    outs = _per_shard(
        mesh, axis, lambda a, b, c: ell_attention(ell, ell_t, a, b, c,
                                                  scale=scale),
        (1, 1, 1), q, k, v)
    return torch.cat(outs, 1) if len(outs) > 1 else outs[0]


def tp_gat_attention(ell, ell_t, mesh: Mesh, a_l, a_r, z, *,
                     axis: str = "head", negative_slope: float = 0.2):
    """Fused GAT core with heads sharded over ``axis``: a_l, a_r ``(h, d)``
    sharded on h; z ``(n, h, d)``."""
    from custom_op_benchmark_tpu_torch.ops import ell_gat_attention

    _check(mesh, axis, z.shape[1])
    outs = _per_shard(
        mesh, axis, lambda al, ar, zz: ell_gat_attention(
            ell, ell_t, al, ar, zz, negative_slope=negative_slope),
        (0, 0, 1), a_l, a_r, z)
    return torch.cat(outs, 1) if len(outs) > 1 else outs[0]


def tp_transformer_block(ell, ell_t, mesh: Mesh, params, x, *,
                         axis: str = "head"):
    """One Megatron-style graph-transformer block: column-parallel QKV,
    head-sharded fused attention, row-parallel output projection whose
    partial products are summed over the head axis in shard order.

    ``params``: wq/wk/wv ``(f, h, d)`` and wo ``(h, d, f)``, their h axis
    sharded over ``axis``; x ``(n, f)`` replicated. Returns ``(n, f)``
    replicated.
    """
    from custom_op_benchmark_tpu_torch.ops import ell_attention

    _check(mesh, axis, params["wq"].shape[1])

    def block(wq, wk, wv, wo):
        q = torch.einsum("nf,fhd->nhd", x, wq)
        k = torch.einsum("nf,fhd->nhd", x, wk)
        v = torch.einsum("nf,fhd->nhd", x, wv)
        out = ell_attention(ell, ell_t, q, k, v)
        return torch.einsum("nhd,hdf->nf", out, wo)

    parts = _per_shard(mesh, axis, block, (1, 1, 1, 0), params["wq"],
                       params["wk"], params["wv"], params["wo"])
    return psum(mesh, axis, torch.stack(parts))[0]
