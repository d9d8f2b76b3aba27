"""Block-sparse tiling (BSR): the tile view that the hand kernels sweep.

The node axes are cut into tiles of ``(tile_r, tile_c)`` and only the
adjacency tiles holding at least one edge are kept. Each op becomes dense
math over tiles whose operands are contiguous row slices of the node
arrays, and every output block is owned by one row (or column) block, so
no atomics are needed. Same layout as the JAX package's ``TiledGraph``
(custom_op_benchmark_tpu/graph/tiled.py); built on the host with numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from custom_op_benchmark_tpu_torch.graph.graph import Graph


@dataclasses.dataclass(frozen=True)
class TiledGraph:
    """Block-sparse view of a :class:`Graph`.

    Tensors (int32 unless stated, on one device):
      tile_rows:   (T,) row-block index of each nonzero tile, nondecreasing
                   (tiles sorted by (row block, col block)).
      tile_cols:   (T,) col-block index of each tile.
      tile_ptr:    (num_row_blocks + 1,) CSR over tiles by row block.
      tile_perm_c: (T,) tile index of the k-th tile in (col block, row
                   block) order — the column-sorted view the backward
                   sweeps use.
      tile_ptr_c:  (num_col_blocks + 1,) CSR over that order.
      mask:        (T, tile_r, tile_c) bool adjacency within each tile.
      edge_tile / edge_r / edge_c: (E,) canonical edge id → (tile, in-tile
                   row, in-tile col); padded edges point at slot (0, 0) of
                   a scratch tile T (see :meth:`scatter_edges`).
    """

    tile_rows: torch.Tensor
    tile_cols: torch.Tensor
    tile_ptr: torch.Tensor
    tile_perm_c: torch.Tensor
    tile_ptr_c: torch.Tensor
    mask: torch.Tensor
    edge_tile: torch.Tensor
    edge_r: torch.Tensor
    edge_c: torch.Tensor
    n_nodes: int
    n_edges: int
    tile_r: int
    tile_c: int
    num_row_blocks: int
    num_col_blocks: int
    num_tiles: int
    max_tiles_per_row: int
    max_tiles_per_col: int
    # The transposed view, built on first use by transpose().
    _transposed: Optional["TiledGraph"] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.mask.device

    @property
    def n_rows_padded(self) -> int:
        return self.num_row_blocks * self.tile_r

    @property
    def n_cols_padded(self) -> int:
        return self.num_col_blocks * self.tile_c

    @property
    def density(self) -> float:
        """Fraction of occupied slots across nonzero tiles."""
        slots = max(self.num_tiles, 1) * self.tile_r * self.tile_c
        return self.n_edges / slots

    def scatter_edges(self, vals: torch.Tensor) -> torch.Tensor:
        """Canonical edge values (E, ...) → (T+1, tile_r, tile_c, ...).

        Slot ``T`` absorbs padded edges; callers slice ``[:T]``. Without
        multi-edges each (tile, r, c) holds at most one edge; duplicate
        edges share a slot, and which of their values lands is unspecified.
        """
        out = vals.new_zeros((self.num_tiles + 1, self.tile_r, self.tile_c)
                             + tuple(vals.shape[1:]))
        out[self.edge_tile.long(), self.edge_r.long(),
            self.edge_c.long()] = vals
        return out

    def gather_edges(self, tiles: torch.Tensor) -> torch.Tensor:
        """Tile-dense values (T, tile_r, tile_c, ...) → (E, ...)."""
        et = torch.clamp(self.edge_tile.long(), max=self.num_tiles - 1)
        return tiles[et, self.edge_r.long(), self.edge_c.long()]

    def transpose(self) -> "TiledGraph":
        """The transpose graph's tiling, sharing this one's edge ids.

        Tiles reorder to (col block, row block) order and each mask tile
        transposes. Built once and cached on both views, so the
        ``normalize="dst"`` attention of every layer reuses it.
        """
        if self._transposed is not None:
            return self._transposed
        perm = self.tile_perm_c.long()
        inv = torch.argsort(perm).to(torch.int32)
        edge_tile = self.edge_tile
        if self.num_tiles:
            et = edge_tile.long()
            # Padded edges keep the scratch slot T.
            edge_tile = torch.where(
                et >= self.num_tiles, et,
                inv.long()[et.clamp(max=self.num_tiles - 1)],
            ).to(torch.int32)
        t = TiledGraph(
            tile_rows=self.tile_cols[perm],
            tile_cols=self.tile_rows[perm],
            tile_ptr=self.tile_ptr_c,
            tile_perm_c=inv,
            tile_ptr_c=self.tile_ptr,
            mask=self.mask.transpose(1, 2)[perm].contiguous(),
            edge_tile=edge_tile,
            edge_r=self.edge_c,
            edge_c=self.edge_r,
            n_nodes=self.n_nodes,
            n_edges=self.n_edges,
            tile_r=self.tile_c,
            tile_c=self.tile_r,
            num_row_blocks=self.num_col_blocks,
            num_col_blocks=self.num_row_blocks,
            num_tiles=self.num_tiles,
            max_tiles_per_row=self.max_tiles_per_col,
            max_tiles_per_col=self.max_tiles_per_row,
        )
        object.__setattr__(t, "_transposed", self)
        object.__setattr__(self, "_transposed", t)
        return t

    def to(self, device) -> "TiledGraph":
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **moved)


def tile_graph(g: Graph, tile_r: int = 128, tile_c: int = 128, *,
               device=None) -> TiledGraph:
    """Build the block-sparse view of ``g`` on the host; tensors go to
    ``device`` (default: the graph's device)."""
    device = g.device if device is None else device
    src = g.src.cpu().numpy()[: g.n_edges].astype(np.int64)
    dst = g.dst.cpu().numpy()[: g.n_edges].astype(np.int64)
    nrb = max(1, -(-g.n_nodes // tile_r))
    ncb = max(1, -(-g.n_nodes // tile_c))
    key = (src // tile_r) * ncb + dst // tile_c
    tile_keys, edge_tile = np.unique(key, return_inverse=True)
    t = len(tile_keys)
    tile_rows = (tile_keys // ncb).astype(np.int32)
    tile_cols = (tile_keys % ncb).astype(np.int32)
    tile_ptr = np.zeros(nrb + 1, dtype=np.int32)
    np.cumsum(np.bincount(tile_rows, minlength=nrb), out=tile_ptr[1:])
    er = (src % tile_r).astype(np.int32)
    ec = (dst % tile_c).astype(np.int32)
    mask = np.zeros((t, tile_r, tile_c), dtype=bool)
    mask[edge_tile, er, ec] = True

    perm_c = np.lexsort((tile_rows, tile_cols)).astype(np.int32)
    tile_ptr_c = np.zeros(ncb + 1, dtype=np.int32)
    np.cumsum(np.bincount(tile_cols, minlength=ncb), out=tile_ptr_c[1:])

    e_pad = g.num_edges_padded
    et = np.full(e_pad, t, dtype=np.int32)
    err = np.zeros(e_pad, dtype=np.int32)
    ecc = np.zeros(e_pad, dtype=np.int32)
    et[: g.n_edges] = edge_tile.reshape(-1)
    err[: g.n_edges] = er
    ecc[: g.n_edges] = ec

    def d(a):
        return torch.from_numpy(a).to(device)

    return TiledGraph(
        tile_rows=d(tile_rows), tile_cols=d(tile_cols), tile_ptr=d(tile_ptr),
        tile_perm_c=d(perm_c), tile_ptr_c=d(tile_ptr_c), mask=d(mask),
        edge_tile=d(et), edge_r=d(err), edge_c=d(ecc),
        n_nodes=g.n_nodes, n_edges=g.n_edges, tile_r=tile_r, tile_c=tile_c,
        num_row_blocks=nrb, num_col_blocks=ncb, num_tiles=t,
        max_tiles_per_row=int(np.max(np.diff(tile_ptr))),
        max_tiles_per_col=int(np.max(np.diff(tile_ptr_c))),
    )
