"""Execution-strategy dispatch for the public op API.

Counterpart of custom_op_benchmark_tpu/ops/dispatch.py:

- ``"xla"``          — the segment oracle (ops/xla.py), any graph;
- ``"tiled"``        — the CUDA tile kernels (ops/kernels/) on the
  tile-aligned node order, through ops/tiled.py; ``"pallas"`` is its
  alias, as in the reference, so it reaches the hand kernels;
- ``"dense_block"``  — the component-batched dense layout
  (ops/dense_block.py), for graphs whose components fit a block;
- ``"ell"``          — the degree-bucketed layout (ops/ell.py), general
  graphs;
- ``"auto"``         — the segment path below :data:`AUTO_MIN_EDGES` edges
  (the one-off view build costs more than the op there); above it the
  recommendation of ``utils.summary.describe``, computed once per graph.

The views (tile reorder and tiles, dual ELL packing, dense blocks, the
summary) are built on the host once per :class:`Graph` object and cached
by object identity; the entry goes when the graph is garbage-collected.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from custom_op_benchmark_tpu_torch.graph.graph import Graph

# Below this edge count the segment path wins once the view build is
# counted (the reference's threshold).
AUTO_MIN_EDGES = 20_000

_VIEW_CACHE: dict = {}


def _views_for(g: Graph) -> dict:
    key = id(g)
    entry = _VIEW_CACHE.get(key)
    if entry is None:
        entry = _VIEW_CACHE[key] = {}
        weakref.finalize(g, _VIEW_CACHE.pop, key, None)
    return entry


def resolve(g: Graph, impl: str) -> str:
    """Map the user's ``impl`` to a strategy: ``"xla"``, ``"tiled"``,
    ``"dense_block"`` or ``"ell"``. ``"dense_block"`` raises ValueError on
    a graph that is not blocky."""
    if impl == "pallas":
        impl = "tiled"
    if impl in ("xla", "tiled", "ell"):
        return impl
    if impl == "dense_block":
        if get_block(g) is None:
            raise ValueError(
                "impl='dense_block' requires every component to fit a "
                "dense block; this graph is not blocky (use impl='auto').")
        return impl
    if impl != "auto":
        raise ValueError("impl must be one of auto/xla/pallas/dense_block/"
                         f"tiled/ell, got {impl!r}")
    if g.n_edges < AUTO_MIN_EDGES:
        return "xla"
    rec = summary(g).recommended
    if rec == "dense_block" and get_block(g) is not None:
        return "dense_block"
    if rec.startswith("tiled"):
        return "tiled"
    if rec == "ell":
        return "ell"
    return "xla"


def summary(g: Graph):
    """``utils.summary.describe(g)``, cached per graph."""
    views = _views_for(g)
    if "summary" not in views:
        from custom_op_benchmark_tpu_torch.utils.summary import describe

        views["summary"] = describe(g)
    return views["summary"]


def get_block(g: Graph):
    """The BlockGraph view (None if the graph is not blocky), cached per
    graph, on the graph's device."""
    views = _views_for(g)
    if "block" not in views:
        from custom_op_benchmark_tpu_torch.graph.blockdiag import block_graph

        views["block"] = block_graph(g)
    return views["block"]


def get_ell(g: Graph):
    """(src_ell, dst_ell): the dual ELL packing, cached per graph, on the
    graph's device."""
    views = _views_for(g)
    if "ell" not in views:
        from custom_op_benchmark_tpu_torch.ops.ell import ell_dual

        views["ell"] = ell_dual(g)
    return views["ell"]


def get_tiled(g: Graph):
    """(ro, tg, eperm, eperm_inv): tile-aligned reorder and 128×128 tiling,
    cached per graph, on the graph's device.

    ``eperm`` maps the reordered graph's canonical edge k to the original
    canonical edge id (a padded tail to a padded original edge);
    ``eperm_inv`` maps an original edge id to its reordered position, the
    padded tail to the last slot.
    """
    views = _views_for(g)
    if "tiled" not in views:
        from custom_op_benchmark_tpu_torch.graph.reorder import (
            reorder_graph,
            tile_aligned_order,
        )
        from custom_op_benchmark_tpu_torch.graph.tiled import tile_graph

        ro = tile_aligned_order(g, block=128)
        g2, eperm = reorder_graph(g, ro)
        tg = tile_graph(g2, 128, 128)
        eperm_full = np.full(g2.num_edges_padded, g.num_edges_padded - 1,
                             dtype=np.int64)
        eperm_full[: len(eperm)] = eperm
        eperm_inv = np.full(g.num_edges_padded, g2.num_edges_padded - 1,
                            dtype=np.int64)
        eperm_inv[eperm] = np.arange(len(eperm))
        views["tiled"] = (ro, tg, torch.from_numpy(eperm_full).to(g.device),
                          torch.from_numpy(eperm_inv).to(g.device))
    return views["tiled"]


# ---------------------------------------------------------------------------
# Op routing, for the strategies ``resolve`` returns other than "xla":
# "tiled", "dense_block" or "ell". Each function takes the original operand
# shapes — (n, d) or (n, h, d) nodes, (E,) or (E, h) edges — and returns
# results in canonical edge or node order with matching rank, as the
# segment path does. Heads are the tile kernels' own grid axis (the
# reference vmaps over them).
# ---------------------------------------------------------------------------

def _edges_to_tiles(tg, eperm, x):
    """Canonical edge values (E[, h]) → tile-dense (T, R, C) or
    (h, T, R, C)."""
    s = tg.scatter_edges(x[eperm])[: tg.num_tiles]
    return s if x.dim() == 1 else s.permute(3, 0, 1, 2)


def _tiles_to_edges(tg, eperm_inv, s):
    """Tile-dense (T, R, C) or (h, T, R, C) → canonical (E[, h])."""
    if s.dim() == 4:
        s = s.permute(1, 2, 3, 0)
    return tg.gather_edges(s)[eperm_inv]


def sddmm(strategy: str, g, A, B):
    if strategy == "dense_block":
        from custom_op_benchmark_tpu_torch.ops.dense_block import block_sddmm

        bg = get_block(g)
        return bg.gather_edges(block_sddmm(bg, bg.scatter_nodes(A),
                                           bg.scatter_nodes(B)))
    if strategy == "ell":
        from custom_op_benchmark_tpu_torch.ops.ell import ell_sddmm

        return ell_sddmm(*get_ell(g), A, B)
    from custom_op_benchmark_tpu_torch.ops.tiled import tiled_sddmm

    ro, tg, _, eperm_inv = get_tiled(g)
    s = tiled_sddmm(tg, ro.scatter_nodes(A), ro.scatter_nodes(B))
    return _tiles_to_edges(tg, eperm_inv, s)


def vector_spmm(strategy: str, g, edata, x):
    if strategy == "dense_block":
        from custom_op_benchmark_tpu_torch.ops.dense_block import block_spmm

        bg = get_block(g)
        return bg.gather_nodes(block_spmm(bg, bg.scatter_edges(edata),
                                          bg.scatter_nodes(x)))
    if strategy == "ell":
        from custom_op_benchmark_tpu_torch.ops.ell import ell_spmm

        return ell_spmm(*get_ell(g), edata, x)[: x.shape[0]]
    from custom_op_benchmark_tpu_torch.ops.tiled import tiled_spmm

    ro, tg, eperm, _ = get_tiled(g)
    vals = _edges_to_tiles(tg, eperm, edata)
    return ro.gather_nodes(tiled_spmm(tg, vals, ro.scatter_nodes(x),
                                      out_rows=ro.n_new))


def edge_softmax(strategy: str, g, x, by: str):
    if strategy == "dense_block":
        from custom_op_benchmark_tpu_torch.ops.dense_block import (
            block_softmax,
        )

        bg = get_block(g)
        return bg.gather_edges(block_softmax(bg, bg.scatter_edges(x), by=by))
    if strategy == "ell":
        from custom_op_benchmark_tpu_torch.ops.ell import ell_softmax

        se, de = get_ell(g)
        return ell_softmax(se if by == "src" else de, x)[: x.shape[0]]
    from custom_op_benchmark_tpu_torch.ops.tiled import tiled_softmax

    _, tg, eperm, eperm_inv = get_tiled(g)
    y = tiled_softmax(tg, _edges_to_tiles(tg, eperm, x), by=by)
    return _tiles_to_edges(tg, eperm_inv, y)


def node_mul_edge(strategy: str, g, A, Be):
    """Dense blocks or ELL: the tiled strategy has no kernel for it, and the
    caller routes it to ELL, as in the reference."""
    if strategy == "dense_block":
        from custom_op_benchmark_tpu_torch.ops.dense_block import (
            block_node_mul_edge,
        )

        bg = get_block(g)
        return bg.gather_edges(block_node_mul_edge(
            bg, bg.scatter_nodes(A), bg.scatter_edges(Be)))
    from custom_op_benchmark_tpu_torch.ops.ell import ell_node_mul_edge

    return ell_node_mul_edge(*get_ell(g), A, Be)[: Be.shape[0]]


def attention(strategy: str, g, q, k, v, scale: float, edge_bias=None):
    if strategy == "dense_block":
        from custom_op_benchmark_tpu_torch.ops.dense_block import (
            block_attention,
            block_node_mul_edge,
            block_sddmm,
            block_softmax,
        )

        bg = get_block(g)
        qb, kb, vb = (bg.scatter_nodes(q), bg.scatter_nodes(k),
                      bg.scatter_nodes(v))
        if edge_bias is None:
            return bg.gather_nodes(block_attention(bg, qb, kb, vb,
                                                   scale=scale,
                                                   normalize="dst"))
        s = block_sddmm(bg, kb, qb)            # <k[src], q[dst]>
        s = s + block_node_mul_edge(bg, qb, bg.scatter_edges(edge_bias))
        alpha = block_softmax(bg, s * scale, by="dst")
        spec = "bxy,bxd->byd" if qb.dim() == 3 else "bxyh,bxhd->byhd"
        y = torch.einsum(spec, alpha.float(), vb.float()).to(v.dtype)
        return bg.gather_nodes(y)
    if strategy == "ell":
        from custom_op_benchmark_tpu_torch.ops.ell import (
            ell_attention,
            ell_edge_bias_attention,
        )

        se, de = get_ell(g)
        if edge_bias is None:
            return ell_attention(de, se, q, k, v, scale=scale)
        return ell_edge_bias_attention(de, se, q, k, v, edge_bias,
                                       scale=scale)
    from custom_op_benchmark_tpu_torch.ops.tiled import tiled_attention

    assert edge_bias is None  # the caller routes edge-bias to ELL
    ro, tg, _, _ = get_tiled(g)
    y = tiled_attention(tg, ro.scatter_nodes(q), ro.scatter_nodes(k),
                        ro.scatter_nodes(v), scale=scale, normalize="dst")
    return ro.gather_nodes(y)


def gat_attention(strategy: str, g, a_l, a_r, z, negative_slope: float):
    """Dense blocks or ELL: the tiled strategy has no kernel for it, and the
    caller routes it to ELL, as in the reference."""
    if strategy == "dense_block":
        from custom_op_benchmark_tpu_torch.ops.dense_block import (
            block_gat_attention,
        )

        bg = get_block(g)
        return bg.gather_nodes(block_gat_attention(
            bg, a_l, a_r, bg.scatter_nodes(z),
            negative_slope=negative_slope))
    from custom_op_benchmark_tpu_torch.ops.ell import ell_gat_attention

    se, de = get_ell(g)
    return ell_gat_attention(de, se, a_l, a_r, z,
                             negative_slope=negative_slope)
