"""ELL packing: the degree-bucketed, row-owned edge layout for general graphs.

Same layout as the JAX package's ``EllGraph`` (custom_op_benchmark_tpu/
graph/ell.py), held as torch tensors:

- rows are grouped into **degree buckets**; bucket ``b`` stores its rows'
  edges as a dense ``(R_b, D_b)`` index matrix padded with the dummy node
  ``n_nodes`` (ELLPACK), ``R_b`` a multiple of ``row_pad``;
- every node lives in exactly one packed row, so node outputs are
  assembled with a **gather** through ``row_pos``, and canonical-edge
  results with a gather through ``edge_pos``: no scatter, no atomics;
- the backward passes run the forward sweeps over the transpose packing.

Packing runs on the host, in the native graphcore library where it builds
(graph/native.py ``ell_pack_native``) and in numpy otherwise; both give the
same arrays, as the JAX package's two packers do. The tensors then move to
the graph's device. Each packing also carries, built on first use and cached, the
table that the copy-sum kernel S3 sweeps in one launch over all buckets
(:class:`GatherTable`), its rows' degrees, and where the table's slots lie
in the flat slot order and in the twin packing's (``table_flat``,
``table_twin``: the GAT sweeps' per-slot values cross between the
packings there).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from custom_op_benchmark_tpu_torch.graph import native
from custom_op_benchmark_tpu_torch.graph.graph import Graph

# Power-of-two bucket widths; ell_pack extends the list by doubling to cover
# the max degree, so rows are never split.
DEFAULT_WIDTHS = (4, 8, 16, 32, 64, 128, 256, 512, 1024)

# The training-profile ladder (``ell_dual(g, profile="train")``): finer
# buckets pad less, which the backward's slot-scale sweeps pay for.
TRAIN_WIDTHS = tuple(range(4, 65, 4)) + (96, 128, 192, 256, 384, 512,
                                         768, 1024)

# The table engine that S3 and the GAT sweeps share (csrc/ell_table.cuh):
# the buckets its table in shared memory holds, and the slots a piece of a
# long row takes.
MAX_BUCKETS = 64
PIECE = 256


@dataclasses.dataclass(frozen=True)
class EllBucket:
    """Rows whose degree fits width D, edges padded to (num_rows, D).

    rows: (R,) int32 owner node of each packed row; padding rows = n_nodes.
    cols: (R, D) int32 neighbour per slot; padding = n_nodes.
    eid:  (R, D) int32 canonical edge id per slot; padding = E_pad.
    """

    rows: torch.Tensor
    cols: torch.Tensor
    eid: torch.Tensor
    width: int
    num_rows: int

    def to(self, device) -> "EllBucket":
        return dataclasses.replace(self, rows=self.rows.to(device),
                                   cols=self.cols.to(device),
                                   eid=self.eid.to(device))


@dataclasses.dataclass(frozen=True)
class GatherTable:
    """The rows the copy-sum S3 sums in one launch, and where each sum goes.

    buckets:    (B, 3) int32 — per bucket, widest first: the offset of its
                rows' slots in ``cols``, its width D and its first row.
    cols:       (S,) int32 — each bucket's rows of D slots, concatenated;
                a slot outside [0, n_x) adds zero.
    nodes:      (R,) int32 — the output row of each summed row.
    zero_nodes: (Z,) int32 — output rows with nothing to sum; written 0.
    n_out:      rows of the output; ``nodes`` and ``zero_nodes`` together
                name each of them once.
    layout:     the host's copy of the buckets, ``((offset, width, first
                row, rows), ...)``: S3's wrapper sizes its launch and its
                scratch from it without reading the card.

    S3's warp tasks are numbered over the rows in this order (times the
    feature chunks), then the zero rows, so the widest rows start first.
    """

    buckets: torch.Tensor
    cols: torch.Tensor
    nodes: torch.Tensor
    zero_nodes: torch.Tensor
    n_out: int
    layout: tuple

    @property
    def device(self) -> torch.device:
        return self.cols.device

    def bucket_rows(self):
        """[(col offset, width, first row, rows)] per bucket (host ints)."""
        return [tuple(e) for e in self.layout]

    def to(self, device) -> "GatherTable":
        return dataclasses.replace(
            self, buckets=self.buckets.to(device), cols=self.cols.to(device),
            nodes=self.nodes.to(device),
            zero_nodes=self.zero_nodes.to(device))


def ell_launch(table: GatherTable):
    """(units, split rows, pieces) of the table engine's two passes over
    ``table``, from its host layout: the rows' pieces plus the zero rows,
    the rows wider than PIECE and their pieces."""
    units = int(table.zero_nodes.shape[0])
    split = pieces = 0
    for _, w, _, rows in table.layout:
        p = max(1, -(-w // PIECE))
        units += rows * p
        if p > 1:
            split += rows
            pieces += rows * p
    return units, split, pieces


@functools.lru_cache(maxsize=64)
def _one_bucket(width: int, device: torch.device) -> torch.Tensor:
    # Made once a width and device: a fresh host tensor copied to the card
    # each call would wait for the card's queue (a sampled batch calls S3
    # on its in_cols every step).
    return torch.tensor([[0, width, 0]], dtype=torch.int32, device=device)


def one_bucket_table(cols: torch.Tensor) -> GatherTable:
    """The table of one bucket ``cols`` (R, D): output row r sums row r."""
    r, w = cols.shape
    dev = cols.device
    return GatherTable(
        buckets=_one_bucket(w, dev),
        cols=cols.reshape(-1),
        nodes=torch.arange(r, dtype=torch.int32, device=dev),
        zero_nodes=torch.zeros(0, dtype=torch.int32, device=dev), n_out=r,
        layout=((0, w, 0, r),))


@dataclasses.dataclass(frozen=True)
class EllGraph:
    """Degree-bucketed ELL view of one traversal direction of a Graph.

    ``direction="src"`` packs out-edges (row = src, CSR order), ``"dst"``
    in-edges (row = dst, CSC order).

    row_pos:  (n_nodes,) int32 packed-row index of each node in the bucket
              concatenation; ``total_rows`` (an appended zeros row) for
              zero-degree nodes.
    edge_pos: (E_pad,) int32 flattened slot of each canonical edge in the
              concatenation of the buckets' ``(R·D,)`` flats;
              ``total_slots`` for padded edges.
    twin_slot: filled by ``ops.ell.ell_dual``: per bucket, ``(R, D)`` int32
              flattened slot, in the twin packing's concatenation, of the
              edge at each slot; padding slots point at the twin's zero slot
              (its ``total_slots``).
    """

    buckets: List[EllBucket]
    row_pos: torch.Tensor
    edge_pos: torch.Tensor
    n_nodes: int
    n_edges: int
    num_edges_padded: int
    direction: str
    total_rows: int
    total_slots: int
    twin_slot: Optional[List[torch.Tensor]] = None

    @property
    def device(self) -> torch.device:
        return self.row_pos.device

    @property
    def padding_waste(self) -> float:
        """Total padded slots / real edges (layout efficiency)."""
        return self.total_slots / max(self.n_edges, 1)

    def to(self, device) -> "EllGraph":
        twin = (None if self.twin_slot is None
                else [t.to(device) for t in self.twin_slot])
        return dataclasses.replace(
            self, buckets=[b.to(device) for b in self.buckets],
            row_pos=self.row_pos.to(device), edge_pos=self.edge_pos.to(device),
            twin_slot=twin)

    @functools.cached_property
    def gather_table(self) -> GatherTable:
        """S3's table of this packing: every bucket's real rows, widest
        bucket first, each summed into its node's output row; nodes of
        degree 0 are the zero rows. Built on the host once, on this
        packing's device."""
        n = self.n_nodes
        table, cols, nodes = [], [], []
        off = row = 0
        for i in self._widest_first():
            b = self.buckets[i]
            owners = _host(b.rows)
            real = owners < n
            c = _host(b.cols)[real]
            table.append((off, b.width, row))
            cols.append(c.reshape(-1))
            nodes.append(owners[real])
            off += c.size
            row += int(real.sum())
        has_row = np.zeros(n, dtype=bool)
        if nodes:
            has_row[np.concatenate(nodes)] = True

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))

        empty = np.zeros(0, dtype=np.int32)
        tab = GatherTable(
            buckets=t(np.asarray(table, dtype=np.int32).reshape(-1, 3)),
            cols=t(np.concatenate(cols) if cols else empty),
            nodes=t(np.concatenate(nodes) if nodes else empty),
            zero_nodes=t(np.flatnonzero(~has_row)), n_out=n,
            layout=tuple((int(o), int(w), int(r0), len(c))
                         for (o, w, r0), c in zip(table, nodes)))
        return tab if self.device.type == "cpu" else tab.to(self.device)

    def _widest_first(self) -> List[int]:
        """The buckets' indices in the order of :attr:`gather_table`."""
        return sorted(range(len(self.buckets)),
                      key=lambda i: -self.buckets[i].width)

    @functools.cached_property
    def table_flat(self) -> torch.Tensor:
        """(S,) int32: for each slot of ``gather_table.cols``, its slot in
        the concatenation of the buckets' ``(R·D,)`` flats, the order that
        ``edge_pos`` and ``twin_slot`` index (a table row is its bucket's
        row of the same owner). Built on the host once, on this packing's
        device."""
        base = np.cumsum([0] + [b.num_rows * b.width for b in self.buckets])
        flat = [np.zeros(0, dtype=np.int64)]
        for i in self._widest_first():
            b = self.buckets[i]
            real = np.flatnonzero(_host(b.rows) < self.n_nodes)
            flat.append((base[i] + real[:, None] * b.width
                         + np.arange(b.width)).reshape(-1))
        return torch.from_numpy(
            np.concatenate(flat).astype(np.int32)).to(self.device)

    @functools.cached_property
    def table_twin(self) -> torch.Tensor:
        """(S,) int32: ``twin_slot`` in ``gather_table``'s slot order, so
        for each slot the slot of its edge in the twin packing's flat
        order (the twin's ``total_slots`` for a pad slot). Needs a packing
        from ``ops.ell.ell_dual``."""
        if self.twin_slot is None:
            raise ValueError("table_twin needs twin_slot: build the "
                             "packings with ops.ell.ell_dual")
        twin = np.concatenate([np.zeros(0, dtype=np.int32)]
                              + [_host(t).reshape(-1)
                                 for t in self.twin_slot])
        return torch.from_numpy(
            np.ascontiguousarray(twin[_host(self.table_flat)])).to(
                self.device)

    @functools.cached_property
    def row_degree(self) -> torch.Tensor:
        """(n_nodes,) float32: the real slots of each node's row (0 for a
        node with no row), counted once on the host; exact below 2^24."""
        deg = np.zeros(self.n_nodes, dtype=np.float32)
        for b in self.buckets:
            owners = _host(b.rows)
            real = owners < self.n_nodes
            deg[owners[real]] = (_host(b.cols)[real] < self.n_nodes).sum(1)
        return torch.from_numpy(deg).to(self.device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _ell_from_native(packed, widths, n, e, e_pad, direction) -> EllGraph:
    """An EllGraph from ``ell_pack_native``'s flat outputs."""
    bucket_rows, rows_flat, cols_flat, eid_flat, row_pos, edge_pos = packed
    buckets = []
    row_off = slot_off = 0
    for w, r_pad in zip(widths, bucket_rows.tolist()):
        if r_pad == 0:
            continue
        slots = slice(slot_off, slot_off + r_pad * w)
        buckets.append(EllBucket(
            rows=torch.from_numpy(rows_flat[row_off: row_off + r_pad]),
            cols=torch.from_numpy(cols_flat[slots].reshape(r_pad, w)),
            eid=torch.from_numpy(eid_flat[slots].reshape(r_pad, w)),
            width=int(w), num_rows=int(r_pad)))
        row_off += r_pad
        slot_off += r_pad * w
    return EllGraph(
        buckets=buckets, row_pos=torch.from_numpy(row_pos),
        edge_pos=torch.from_numpy(edge_pos.astype(np.int32)),
        n_nodes=n, n_edges=e, num_edges_padded=e_pad, direction=direction,
        total_rows=int(row_off), total_slots=int(slot_off))


def ell_pack(g: Graph, *, direction: str = "src",
             widths: Tuple[int, ...] = DEFAULT_WIDTHS,
             row_pad: int = 8) -> EllGraph:
    """Pack one traversal direction of ``g`` into degree buckets, on the
    host; the tensors go to the graph's device.

    Rows with degree 0 are dropped (their output rows read an appended zeros
    row through ``row_pos``). ``widths`` is extended by doubling until it
    covers the max degree, so per-row reductions are whole-segment.
    """
    if direction == "src":
        indptr = _host(g.indptr_r)[: g.n_nodes + 1]
        cols_all = _host(g.dst)
        eids_all = np.arange(g.num_edges_padded, dtype=np.int64)
    elif direction == "dst":
        indptr = _host(g.indptr_c)[: g.n_nodes + 1]
        perm = _host(g.csc_perm)
        cols_all = _host(g.src)[perm]
        eids_all = perm.astype(np.int64)
    else:
        raise ValueError(f"direction must be 'src'/'dst', got {direction!r}")

    n, e = g.n_nodes, g.n_edges
    e_pad = g.num_edges_padded
    deg = np.diff(indptr).astype(np.int64)
    widths = sorted(set(int(w) for w in widths))
    max_deg = int(deg.max()) if len(deg) else 0
    while widths[-1] < max_deg:
        widths.append(widths[-1] * 2)

    packed = (native.ell_pack_native(indptr, cols_all, eids_all, n, e_pad,
                                     widths, row_pad) if e > 0 else None)
    if packed is not None:
        eg = _ell_from_native(packed, widths, n, e, e_pad, direction)
        return eg if g.device.type == "cpu" else eg.to(g.device)

    buckets = []
    row_pos = np.full(n, -1, dtype=np.int64)
    edge_pos = np.full(e_pad, -1, dtype=np.int64)
    row_base = slot_base = w_lo = 0
    for w in widths:
        sel = np.nonzero((deg > w_lo) & (deg <= w))[0]
        w_lo = w
        r = len(sel)
        if r == 0:
            continue
        r_pad = -(-r // row_pad) * row_pad
        cols = np.full((r_pad, w), n, dtype=np.int32)
        eid = np.full((r_pad, w), e_pad, dtype=np.int32)
        rows = np.full(r_pad, n, dtype=np.int32)
        rows[:r] = sel
        # Slot (j, k) <- edge indptr[sel[j]] + k for k < deg.
        k = np.arange(w)
        mask = k[None, :] < deg[sel][:, None]
        flat_eids = (indptr[sel][:, None] + k[None, :])[mask]
        jj, kk = np.nonzero(mask)
        cols[jj, kk] = cols_all[flat_eids]
        eid[jj, kk] = eids_all[flat_eids]
        row_pos[sel] = row_base + np.arange(r)
        edge_pos[eids_all[flat_eids]] = slot_base + jj * w + kk
        buckets.append(EllBucket(rows=torch.from_numpy(rows),
                                 cols=torch.from_numpy(cols),
                                 eid=torch.from_numpy(eid),
                                 width=int(w), num_rows=int(r_pad)))
        row_base += r_pad
        slot_base += r_pad * w

    row_pos[row_pos < 0] = row_base
    edge_pos[edge_pos < 0] = slot_base
    if slot_base >= 2 ** 31:
        # edge_pos is stored as int32: refuse rather than truncate.
        raise ValueError("ELL slot space exceeds int32 indexing")
    eg = EllGraph(
        buckets=buckets,
        row_pos=torch.from_numpy(row_pos.astype(np.int32)),
        edge_pos=torch.from_numpy(edge_pos.astype(np.int32)),
        n_nodes=n, n_edges=e, num_edges_padded=e_pad, direction=direction,
        total_rows=int(row_base), total_slots=int(slot_base),
    )
    return eg if g.device.type == "cpu" else eg.to(g.device)
