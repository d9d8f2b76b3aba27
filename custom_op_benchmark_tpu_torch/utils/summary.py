"""Graph diagnostics and the execution-strategy advisor.

Counterpart of custom_op_benchmark_tpu/utils/summary.py. ``describe(g)``
reports the structural statistics that decide which strategy to run, and
recommends one by the reference's rule:

- ``dense_block``: every component fits a dense (B, L, L) block;
- ``tiled (after tile_aligned_order)``: the occupied 128×128 tiles hold
  fewer node rows than the ELL sweep would gather slots (t·128 < 1.5·e);
- ``ell``: everything else (power-law graphs, no locality).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from custom_op_benchmark_tpu_torch.graph.reorder import connected_components


@dataclasses.dataclass
class GraphSummary:
    n_nodes: int
    n_edges: int
    avg_degree: float
    max_in_degree: int
    max_out_degree: int
    num_components: int
    max_component: int
    tile_density_128: float        # occupied-slot fraction of 128² tiles
    recommended: str

    def __str__(self):
        return (
            f"Graph(n={self.n_nodes}, e={self.n_edges}, "
            f"avg_deg={self.avg_degree:.1f}, "
            f"max_deg_in/out={self.max_in_degree}/{self.max_out_degree}, "
            f"components={self.num_components} "
            f"(max {self.max_component}), "
            f"tile128_density={self.tile_density_128:.3f}) "
            f"→ strategy: {self.recommended}"
        )


def describe(g, max_block: int = 128) -> GraphSummary:
    """Structural summary and recommended execution strategy for ``g``.

    The rule compares byte models, as the reference does: the tile sweep
    reads about t·128 node rows (one (128, d) tile of x per occupied tile),
    the ELL sweep about 1.5·e padded slot rows.
    """
    n, e = g.n_nodes, g.n_edges
    src = g.src.cpu().numpy()[:e].astype(np.int64)
    dst = g.dst.cpu().numpy()[:e].astype(np.int64)
    out_deg = np.bincount(src, minlength=n) if e else np.zeros(n, int)
    in_deg = np.bincount(dst, minlength=n) if e else np.zeros(n, int)
    labels = connected_components(src, dst, n)
    _, counts = np.unique(labels, return_counts=True)
    max_comp = int(counts.max()) if counts.size else 0

    keys = (src // 128) * ((n // 128) + 1) + dst // 128
    t = len(np.unique(keys)) if e else 0
    dens = e / max(t * 128 * 128, 1)

    if max_comp <= max_block and counts.size:
        rec = "dense_block"
    elif t * 128 < 1.5 * e:
        rec = "tiled (after tile_aligned_order)"
    else:
        rec = "ell"
    return GraphSummary(
        n_nodes=n,
        n_edges=e,
        avg_degree=e / max(n, 1),
        max_in_degree=int(in_deg.max()) if n else 0,
        max_out_degree=int(out_deg.max()) if n else 0,
        num_components=int(counts.size),
        max_component=max_comp,
        tile_density_128=float(dens),
        recommended=rec,
    )
