"""Halo exchange: owner-computes plans with an all_to_all of boundary rows.

Counterpart of custom_op_benchmark_tpu/parallel/halo.py. Compared with
the gather plan of parallel/shard_ops.py (all_gather everything, then
psum_scatter everything), the halo plan

- puts every edge on the shard that owns its aggregation target (dst), so
  the segment reductions, softmax included, are local: no cross-shard
  max or sum;
- exchanges only the boundary (halo) source rows each shard needs, with
  one all_to_all a layer; source rows that many shards need (hubs) go to
  every shard with one small all_gather instead;
- keeps the exchange beside local compute: each per-shard ELL bucket is
  split at a fixed row into an INTERIOR section (rows whose in-edges read
  only owned rows) and a BOUNDARY section. On the process mesh the
  all_to_all is started (``async_op=True``) before the interior sweeps and
  waited on before the boundary sweeps; the backward starts the reverse
  all_to_all from the transpose buckets' halo sections before their local
  sections. The local mesh has nothing to overlap and keeps the sections,
  so both meshes compute the same thing.

The plans are host-side numpy (or the port's graphcore library, whose
arrays are the same bit for bit), built once per graph and mesh size. The
ops never scatter: ``halo_attention_ell`` and ``halo_spmm_ell`` have the
reference's hand VJPs (gathers through ``row_pos``, ``twin_pos_t``,
``slot_pos``, the reverse exchange landed with the ``recv_pos`` gather and
a sum over the P peers in shard order); the segment forms
(``halo_spmm``, ``halo_gat_attention``) sum on S3's CSR entry over the
sorted ``dst_loc`` (parallel/rows.py), and their exchange is an
``autograd.Function`` whose backward is that same landing.

Arrays are held as blocks with a leading local-shard dimension: the plan's
``(P, ...)`` arrays on the local mesh, this rank's ``(1, ...)`` row on the
process mesh. Node arrays are ``(P·n_per, ...)`` on the local mesh and
``(n_per, ...)`` on the process mesh (``shard_halo_nodes``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.autograd import Function

from custom_op_benchmark_tpu_torch.graph.graph import Graph
from custom_op_benchmark_tpu_torch.parallel import rows as _rows
from custom_op_benchmark_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_start,
    all_to_all_start,
    blocks,
    shard,
    shard_rows,
    unblocks,
    _ordered_sum,
    _psum_scatter_raw,
)
from custom_op_benchmark_tpu_torch.parallel.rows import take_raw

MASK_VALUE = -1e30
DENOM_FLOOR = 1e-30
DEFAULT_WIDTHS = (4, 8, 16, 32, 64, 128, 256, 512, 1024)


def _round_up(x: int, m: int) -> int:
    return -(-max(int(x), 1) // m) * m


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HaloPlanHost:
    """The halo plan's host arrays (numpy, all P shards) and sizes: what
    :func:`halo_graph` places on a mesh, and what a cache keeps.

    send_idx (P, P, M): shard r sends its local rows ``send_idx[r, s]`` to
    shard s (pad n_per, a zero row). src_ext (P, E_p): each edge's source
    in extended local numbering — [0, n_per) owned rows, n_per the zero
    row, n_per+1+r·M+m the m-th row received from shard r,
    n_per+1+P·M+r·K+j the j-th hub of shard r. dst_loc (P, E_p): the local
    dst row, sorted within each shard (pad n_per). eid (P, E_p): the
    canonical edge id of each slot (pad E_pad). hub_idx (P, max(K, 1)):
    each shard's hub rows (pad n_per). hub_pos (P, n_per): an owned row's
    hub slot (K where it is no hub). recv_pos (P, n_per, P): the flat
    position s·M + m of the returned-gradient row peer s holds for local
    row v (P·M where v was not sent to s).
    """

    send_idx: np.ndarray
    src_ext: np.ndarray
    dst_loc: np.ndarray
    eid: np.ndarray
    hub_idx: np.ndarray
    hub_pos: np.ndarray
    recv_pos: np.ndarray
    n_nodes: int
    n_edges: int
    num_parts: int
    n_per: int
    halo: int
    n_hub: int
    edges_per_part: int
    hub_threshold: Optional[int]
    route: str


@dataclasses.dataclass(frozen=True, eq=False)
class HaloGraph:
    """The halo plan on a mesh axis: the host plan's arrays as blocks of
    this process's shards (``(L, ...)`` tensors on the mesh's device),
    its sizes, and the host plan itself (every rank builds it whole)."""

    send_idx: torch.Tensor
    src_ext: torch.Tensor
    dst_loc: torch.Tensor
    eid: torch.Tensor
    hub_idx: torch.Tensor
    hub_pos: torch.Tensor
    recv_pos: torch.Tensor
    n_nodes: int
    n_edges: int
    num_parts: int
    n_per: int
    halo: int
    n_hub: int
    edges_per_part: int
    axis: str
    host: HaloPlanHost = dataclasses.field(repr=False)
    _cache: Dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_pad(self) -> int:
        return self.num_parts * self.n_per

    @property
    def n_ext(self) -> int:
        return (self.n_per + 1 + self.num_parts * self.halo
                + self.num_parts * self.n_hub)

    @property
    def route(self) -> str:
        """Which planner built the plan: ``"native"`` or ``"numpy"``."""
        return self.host.route

    @property
    def halo_fraction(self) -> float:
        """Exchanged and replicated rows over owned rows: P·M all_to_all
        landings plus (P−1)·K hub landings a shard."""
        p = self.num_parts
        return (p * self.halo + (p - 1) * self.n_hub) / max(self.n_per, 1)

    @property
    def comm_bytes_per_exchange(self) -> int:
        """Rows moved per exchange per unit feature byte: the padded
        all_to_all payload and the hub all_gather payload."""
        p = self.num_parts
        return p * p * self.halo + p * (p - 1) * self.n_hub

    def rows(self, name: str) -> _rows.RowIndex:
        """The CSR plans of the segment forms (built once, lazily):
        ``"src_ext"`` over the extended table, ``"dst_loc"`` over the
        owned rows and the zero row."""
        ri = self._cache.get(name)
        if ri is None:
            idx, n = ((self.src_ext, self.n_ext) if name == "src_ext"
                      else (self.dst_loc, self.n_per + 1))
            ri = _rows.row_index(idx, n, idx.device)
            self._cache[name] = ri
        return ri


def _recv_pos(send_idx: np.ndarray, n_per: int) -> np.ndarray:
    """The reverse exchange's landing map (no P² loop)."""
    p, _, m_max = send_idx.shape
    recv_pos = np.full((p, n_per, p), p * m_max, np.int32)
    rr, ss, mm = np.nonzero(send_idx < n_per)
    recv_pos[rr, send_idx[rr, ss, mm], ss] = (ss * m_max + mm).astype(
        np.int32)
    return recv_pos


def _host_edges(g: Graph):
    return (g.src.cpu().numpy()[: g.n_edges],
            g.dst.cpu().numpy()[: g.n_edges])


def halo_plan_host(g: Graph, num_parts: int, pad_multiple: int = 8,
                   hub_threshold=None) -> HaloPlanHost:
    """The host plan of ``g`` over ``num_parts`` shards: owner-of-dst edge
    placement and send lists, by the native planner (counting sorts) when
    the library builds and no hub split is asked for, else by numpy.

    ``hub_threshold``: source rows requested remotely by at least this
    many shards become hubs, replicated by one all_gather instead of
    riding up to P−1 per-pair send lists. ``"auto"`` sweeps τ and keeps
    the split with the least padded wire volume (never worse than no
    hubs).
    """
    from custom_op_benchmark_tpu_torch.graph import native

    p = int(num_parts)
    n, e = g.n_nodes, g.n_edges
    n_per = -(-n // p)
    src_h, dst_h = _host_edges(g)
    nat = None
    if hub_threshold is None:
        nat = native.halo_plan_native(src_h, dst_h, n, p, n_per,
                                      pad_multiple, g.num_edges_padded)
    if nat is not None:
        send_idx, src_ext, dst_loc, eid, e_p, m_max = nat
        hub_idx = np.full((p, 1), n_per, dtype=np.int32)
        hub_pos = np.zeros((p, n_per), dtype=np.int32)
        k_max, tau, route = 0, None, "native"
    else:
        (send_idx, src_ext, dst_loc, eid, e_p, m_max, hub_idx, hub_pos,
         k_max, tau) = _plan_host(src_h, dst_h, e, p, n_per, pad_multiple,
                                  g.num_edges_padded, hub_threshold)
        route = "numpy"
    return HaloPlanHost(
        send_idx=send_idx, src_ext=src_ext, dst_loc=dst_loc, eid=eid,
        hub_idx=hub_idx, hub_pos=hub_pos,
        recv_pos=_recv_pos(send_idx, n_per), n_nodes=n, n_edges=e,
        num_parts=p, n_per=int(n_per), halo=int(m_max), n_hub=int(k_max),
        edges_per_part=int(e_p), hub_threshold=tau, route=route)


def place_halo(host: HaloPlanHost, mesh: Mesh,
               axis: str = "edge") -> HaloGraph:
    """A host plan as blocks on ``mesh``: all shards on the local mesh,
    this rank's on the process mesh."""
    if mesh.shape[axis] != host.num_parts:
        raise ValueError(f"the plan has {host.num_parts} shards, the mesh "
                         f"axis {axis!r} {mesh.shape[axis]}")

    def put(a):
        return shard_rows(mesh, a, axis)

    return HaloGraph(
        send_idx=put(host.send_idx), src_ext=put(host.src_ext),
        dst_loc=put(host.dst_loc), eid=put(host.eid),
        hub_idx=put(host.hub_idx), hub_pos=put(host.hub_pos),
        recv_pos=put(host.recv_pos), n_nodes=host.n_nodes,
        n_edges=host.n_edges, num_parts=host.num_parts, n_per=host.n_per,
        halo=host.halo, n_hub=host.n_hub,
        edges_per_part=host.edges_per_part, axis=axis, host=host)


def halo_graph(g: Graph, mesh: Mesh, axis: str = "edge",
               pad_multiple: int = 8, hub_threshold=None) -> HaloGraph:
    """Build the halo plan of ``g`` for ``mesh[axis]`` and place it (see
    :func:`halo_plan_host`)."""
    host = halo_plan_host(g, mesh.shape[axis], pad_multiple, hub_threshold)
    return place_halo(host, mesh, axis)


def _plan_host(src_h, dst_h, e, p, n_per, pad_multiple, e_pad,
               hub_threshold):
    """The numpy plan core: owner-of-dst placement, send lists, hub split.
    Also returns the hub threshold it used (``"auto"``'s choice)."""
    src = src_h.astype(np.int64)
    dst = dst_h.astype(np.int64)
    k_max = 0
    hub_idx = np.full((p, 1), n_per, dtype=np.int32)
    hub_pos = np.zeros((p, n_per), dtype=np.int32)

    # Sort edges by dst: groups shards (owner = dst // n_per) and sorts
    # the local dst within each shard.
    order = np.argsort(dst, kind="stable")
    src_s = src[order]
    dst_s = dst[order]
    own_s = dst_s // n_per
    cnt = np.bincount(own_s, minlength=p)
    e_p = _round_up(cnt.max() if e else 1, pad_multiple)
    shard_start = np.concatenate([[0], np.cumsum(cnt)])[:p]
    pos_within = np.arange(e, dtype=np.int64) - shard_start[own_s]

    # Halo needs: unique remote (src owner r, shard s, src) triples.
    src_own = src_s // n_per
    rem = src_own != own_s
    r_rem = src_own[rem]
    s_rem = own_s[rem]
    v_rem = src_s[rem]
    vspace = np.int64(p) * n_per + 1
    key = (r_rem * p + s_rem) * vspace + v_rem
    uk = np.unique(key)

    # Hub split: sources with ≥ hub_threshold requesting shards leave the
    # all_to_all sets for the gather table; "auto" sweeps τ and keeps the
    # least total padded wire volume p²·M + p(p−1)·K, "no hubs" included.
    hub_of = np.full(p * n_per, -1, dtype=np.int64)
    if hub_threshold is not None and len(uk):
        req = np.bincount(uk % vspace, minlength=p * n_per)
        if hub_threshold == "auto":
            vsrc_all = uk % vspace
            pair_all = uk // vspace
            best_tau, best_cost = None, None
            for tau in range(2, p + 1):
                keep = req[vsrc_all] < tau
                pc = np.bincount(pair_all[keep], minlength=p * p)
                m_t = _round_up(int(pc.max()) if keep.any() else 1,
                                pad_multiple)
                hn = np.flatnonzero(req[: p * n_per] >= tau)
                k_t = 0
                if len(hn):
                    k_t = _round_up(
                        int(np.bincount(hn // n_per, minlength=p).max()),
                        pad_multiple)
                cost = p * p * m_t + p * (p - 1) * k_t
                if best_cost is None or cost < best_cost:
                    best_tau, best_cost = tau, cost
            plain = p * p * _round_up(
                int(np.bincount(pair_all, minlength=p * p).max()),
                pad_multiple)
            hub_threshold = best_tau if best_cost < plain else p + 1
        hub_nodes = np.flatnonzero(req[: p * n_per] >= int(hub_threshold))
        if len(hub_nodes):
            owner = hub_nodes // n_per
            ocnt = np.bincount(owner, minlength=p)
            k_max = _round_up(int(ocnt.max()), pad_multiple)
            ostart = np.concatenate([[0], np.cumsum(ocnt)])[:p]
            hrank = (np.arange(len(hub_nodes), dtype=np.int64)
                     - ostart[owner])
            hub_idx = np.full((p, k_max), n_per, dtype=np.int32)
            hub_idx[owner, hrank] = (hub_nodes - owner * n_per).astype(
                np.int32)
            hub_pos = np.full((p, n_per), k_max, dtype=np.int32)
            hub_pos[owner, hub_nodes - owner * n_per] = hrank.astype(
                np.int32)
            hub_of[hub_nodes] = owner * k_max + hrank
            uk = uk[hub_of[uk % vspace] < 0]

    pair = uk // vspace
    vsrc = uk % vspace
    pcnt = np.bincount(pair, minlength=p * p)
    m_max = _round_up(pcnt.max() if len(uk) else 1, pad_multiple)
    pair_start = np.concatenate([[0], np.cumsum(pcnt)])
    rank = np.arange(len(uk), dtype=np.int64) - pair_start[pair]

    send_idx = np.full((p * p, m_max), n_per, dtype=np.int32)
    send_idx[pair, rank] = (vsrc - (pair // p) * n_per).astype(np.int32)
    send_idx = send_idx.reshape(p, p, m_max)

    # Extended local src index per edge.
    ext = (src_s - own_s * n_per).astype(np.int64)
    if rem.any():
        hub_slot = hub_of[v_rem]
        tail = hub_slot < 0
        ext_rem = np.empty(len(key), np.int64)
        if tail.any():
            idx = np.searchsorted(uk, key[tail])
            ext_rem[tail] = n_per + 1 + r_rem[tail] * m_max + rank[idx]
        ext_rem[~tail] = n_per + 1 + p * m_max + hub_slot[~tail]
        ext[rem] = ext_rem

    src_ext = np.full((p, e_p), n_per, dtype=np.int32)
    dst_loc = np.full((p, e_p), n_per, dtype=np.int32)
    eid = np.full((p, e_p), e_pad, dtype=np.int32)
    src_ext[own_s, pos_within] = ext.astype(np.int32)
    dst_loc[own_s, pos_within] = (dst_s - own_s * n_per).astype(np.int32)
    eid[own_s, pos_within] = order.astype(np.int32)
    tau = None if hub_threshold in (None, "auto") else int(hub_threshold)
    return (send_idx, src_ext, dst_loc, eid, e_p, m_max, hub_idx, hub_pos,
            k_max, tau)


@dataclasses.dataclass(frozen=True)
class PlanStats:
    """Host-only plan numbers (no device touched): the layout picker's and
    the per-shard budget's inputs."""

    num_parts: int
    n_per: int
    halo: int
    n_hub: int
    edges_per_part: int
    pack_slots: int          # per-shard padded slots, both packings
    interior_frac: float

    @property
    def halo_fraction(self) -> float:
        p = self.num_parts
        return (p * self.halo + (p - 1) * self.n_hub) / max(self.n_per, 1)


def plan_stats(src_h, dst_h, n, e, p, n_per, e_pad, hub_threshold=None,
               widths=DEFAULT_WIDTHS, pad_multiple=8) -> PlanStats:
    """Build the numpy plan and both shared-shape packings a P-mesh would
    get, on the host, and return their static numbers. The packings are
    the native packer's where the library builds (the same arrays as
    numpy's, as in :func:`halo_ell_host`)."""
    (send_idx, src_ext, dst_loc, eid, e_p, m_max, hub_idx, hub_pos,
     k_max, _) = _plan_host(src_h, dst_h, e, p, n_per, pad_multiple, e_pad,
                            hub_threshold)
    n_ext = n_per + 1 + p * m_max + p * k_max
    dst_pack, t_pack, _, _ = _pack_both(src_ext, dst_loc, p, n_per, n_ext,
                                        e_p, widths)
    n_bnd, total_rows = dst_pack[4], dst_pack[6]
    slots = sum(int(np.prod(c.shape[1:])) for c in dst_pack[1])
    slots += sum(int(np.prod(c.shape[1:])) for c in t_pack[1])
    return PlanStats(
        num_parts=p, n_per=n_per, halo=int(m_max), n_hub=int(k_max),
        edges_per_part=int(e_p), pack_slots=int(slots),
        interior_frac=round(1 - sum(n_bnd) / max(total_rows, 1), 4))


def halo_node_sharding(hg: HaloGraph, mesh: Mesh) -> tuple:
    """The spec of node arrays: rows split over the plan's axis."""
    return (hg.axis,)


def shard_halo_nodes(hg: HaloGraph, mesh: Mesh, x, spec=None):
    """Pad a node array (numpy or tensor) to ``P·n_per`` rows and shard it
    (``spec`` defaults to rows over the plan's axis; pass e.g.
    ``("edge", "head")`` for heads over a second axis)."""
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    if x.shape[0] < hg.n_pad:
        pad = [(0, hg.n_pad - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
        x = np.pad(x, pad)
    return shard(mesh, x, spec or halo_node_sharding(hg, mesh))


def halo_edge_data(hg: HaloGraph, mesh: Mesh, edata_canonical):
    """Canonical ``(E_pad, ...)`` edge data → halo slot order
    ``(P·E_p, ...)``, sharded."""
    ed = edata_canonical
    ed = ed.detach().cpu().numpy() if isinstance(ed, torch.Tensor) \
        else np.asarray(ed)
    ed = np.pad(ed, [(0, 1)] + [(0, 0)] * (ed.ndim - 1))
    eid = hg.host.eid.reshape(-1)
    out = ed[np.minimum(eid, ed.shape[0] - 1)]
    return shard_rows(mesh, out, hg.axis)


# ---------------------------------------------------------------------------
# The exchange
# ---------------------------------------------------------------------------

class _Exchange:
    """A started halo exchange of ``(L, n_per, w)`` rows. ``xp`` (the local
    table with its zero row) is ready at once; :meth:`ext` waits for the
    received rows and returns ``[xp; received; hubs]`` ``(L, n_ext, w)``."""

    def __init__(self, mesh: Mesh, hg: HaloGraph, x: torch.Tensor):
        n_l = x.shape[0]
        self.xp = torch.cat([x, x.new_zeros((n_l, 1) + tuple(x.shape[2:]))],
                            1)
        self._a2a = all_to_all_start(mesh, hg.axis,
                                     take_raw(self.xp, hg.send_idx))
        self._hub = (all_gather_start(mesh, hg.axis,
                                      take_raw(self.xp, hg.hub_idx))
                     if hg.n_hub else None)
        self._ext = None

    def ext(self) -> torch.Tensor:
        if self._ext is None:
            n_l, w = self.xp.shape[0], tuple(self.xp.shape[2:])
            parts = [self.xp, self._a2a.wait().reshape((n_l, -1) + w)]
            if self._hub is not None:
                parts.append(self._hub.wait().reshape((n_l, -1) + w))
            self._ext = torch.cat(parts, 1)
        return self._ext


class _Return:
    """The transpose of the exchange, started from the halo region ``d_halo``
    ``(L, P·M + P·K, w)`` of an extended-row cotangent (in the wire
    dtype): the reverse all_to_all (and the hub part's psum_scatter).
    :meth:`land` adds what came back to ``d_local`` ``(L, n_per, w)``
    through the ``recv_pos`` and ``hub_pos`` gathers, summing the P peers
    in shard order in ``d_local``'s dtype; no scatter."""

    def __init__(self, mesh: Mesh, hg: HaloGraph, d_halo: torch.Tensor):
        p, m = hg.num_parts, hg.halo
        n_l, w = d_halo.shape[0], tuple(d_halo.shape[2:])
        self.mesh, self.hg = mesh, hg
        self._a2a = all_to_all_start(
            mesh, hg.axis, d_halo[:, : p * m].reshape((n_l, p, m) + w)
            .contiguous())
        self._hub = d_halo[:, p * m:].reshape((n_l, p, hg.n_hub) + w) \
            if hg.n_hub else None

    def land(self, d_local: torch.Tensor) -> torch.Tensor:
        hg = self.hg
        d_sbuf = self._a2a.wait()
        n_l, w = d_sbuf.shape[0], tuple(d_sbuf.shape[3:])
        flat = torch.cat([d_sbuf.reshape((n_l, -1) + w),
                          d_sbuf.new_zeros((n_l, 1) + w)], 1)
        got = take_raw(flat, hg.recv_pos).to(d_local.dtype)  # (L, n, P, w)
        out = d_local + _ordered_sum(got, 2)
        if self._hub is not None:
            own = _psum_scatter_raw(self.mesh, hg.axis,
                                    self._hub.contiguous())   # (L, K, w)
            ownp = torch.cat([own, own.new_zeros((n_l, 1) + w)], 1)
            out = out + take_raw(ownp, hg.hub_pos).to(d_local.dtype)
        return out


class _ExchangeFn(Function):
    """The exchange as an autograd op (the segment forms): ``(L, n_per,
    w)`` → ``(L, n_ext, w)``; backward: the landed reverse exchange."""

    @staticmethod
    def forward(ctx, mesh, hg, x):
        ctx.mesh, ctx.hg = mesh, hg
        return _Exchange(mesh, hg, x).ext()

    @staticmethod
    def backward(ctx, d_ext):
        hg = ctx.hg
        n = hg.n_per
        ret = _Return(ctx.mesh, hg, d_ext[:, n + 1:])
        return None, None, ret.land(d_ext[:, :n])


def _exchange(mesh, hg, x):
    """Differentiable: local rows ``(L, n_per, ...)`` → extended rows."""
    trail = tuple(x.shape[2:])
    y = _ExchangeFn.apply(mesh, hg, x.reshape(x.shape[:2] + (-1,))
                          .contiguous())
    return y.reshape(y.shape[:2] + trail)


# ---------------------------------------------------------------------------
# The segment forms
# ---------------------------------------------------------------------------

def _check_rows(hg: HaloGraph, mesh: Mesh, x: torch.Tensor):
    n_l = mesh.local_shards(hg.axis)
    if x.shape[0] != n_l * hg.n_per:
        raise ValueError(f"node array of {x.shape[0]} rows; the plan's "
                         f"shards here hold {n_l}×{hg.n_per}")
    return n_l


def halo_spmm(hg: HaloGraph, mesh: Mesh, edata, x):
    """``out[v] = Σ_{e=(u,v)} edata[e]·x[u]`` over the in-edges of each owned
    row. edata: ``(P·E_p, ...)`` in the plan's slot order
    (:func:`halo_edge_data`); x: node-sharded ``(P·n_per, ...)``."""
    _check_rows(hg, mesh, x)
    xb = blocks(mesh, hg.axis, x)
    ed = blocks(mesh, hg.axis, edata)
    x_ext = _exchange(mesh, hg, xb)
    xs = _rows.take(x_ext, hg.rows("src_ext"))
    msg = ed.reshape(ed.shape + (1,) * (xs.dim() - ed.dim())) * xs
    out = _rows.segment_sum(msg, hg.rows("dst_loc"))[:, : hg.n_per]
    return unblocks(out)


def halo_gat_attention(hg: HaloGraph, mesh: Mesh, q, k, v):
    """Fused attention with local softmax segments: every in-edge of an
    owned row lives on its owner, so the softmax's max and sum are sorted
    segment reductions on the shard. q, k, v: ``(P·n_per, h, d)``."""
    _check_rows(hg, mesh, q)
    d = q.shape[-1]
    qb, kb, vb = (blocks(mesh, hg.axis, t) for t in (q, k, v))
    k_ext = _exchange(mesh, hg, kb)
    v_ext = _exchange(mesh, hg, vb)
    se, dl = hg.rows("src_ext"), hg.rows("dst_loc")
    n_l = qb.shape[0]
    qp = torch.cat([qb, qb.new_zeros((n_l, 1) + tuple(qb.shape[2:]))], 1)
    scores = torch.einsum("lehd,lehd->leh", _rows.take(k_ext, se),
                          _rows.take(qp, dl)) / math.sqrt(d)
    valid = (hg.dst_loc < hg.n_per)[..., None]
    scores = torch.where(valid, scores, MASK_VALUE)
    m = _rows.segment_max(scores.detach(), dl)
    z = torch.where(valid, torch.exp(scores - take_raw(m, hg.dst_loc)), 0.0)
    ssum = _rows.segment_sum(z, dl)
    alpha = z / _rows.take(ssum, dl).clamp(min=DENOM_FLOOR)
    contrib = alpha[..., None] * _rows.take(v_ext, se)
    return unblocks(_rows.segment_sum(contrib, dl)[:, : hg.n_per])


# ---------------------------------------------------------------------------
# Per-shard ELL packing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HaloEllHost:
    """The per-shard ELL packing's host arrays (all P shards); see
    :class:`HaloEll`."""

    rows_b: list
    cols_b: list
    epos_b: list
    row_pos: np.ndarray
    rows_t_b: list
    cols_t_b: list
    epos_t_b: list
    row_pos_t: np.ndarray
    halo_pos_t: np.ndarray
    recv_pos: np.ndarray
    slot_pos: np.ndarray
    twin_pos_t: list
    widths: tuple
    n_bnd: tuple
    n_halo_t: tuple
    total_rows: int
    total_rows_t: int
    halo_rows_t: int
    n_per: int
    route: str


@dataclasses.dataclass(frozen=True, eq=False)
class HaloEll:
    """Stacked per-shard ELL packing of a HaloGraph's local edges.

    Bucket shapes are shared across shards (rows padded to the largest
    shard). ``cols`` index the extended local rows of the exchange (pad
    n_per, the zero row); ``rows`` are local dst rows (pad n_per). Each
    dst bucket keeps its INTERIOR rows (every col ≤ n_per) first and its
    BOUNDARY rows in a tail of ``n_bnd[i]`` rows; each transpose bucket
    keeps its HALO rows (extended source ≥ n_per+1, whose cotangents ride
    the reverse exchange) in a head of ``n_halo_t[i]`` rows.

    Blocks ``(L, ...)``: rows_b (L, R), cols_b / epos_b (L, R, D) per
    bucket, row_pos (L, n_per); the transpose packing rows_t_b (L, Rt),
    cols_t_b / epos_t_b / twin_pos_t (L, Rt, Dt), row_pos_t (L, n_ext),
    halo_pos_t (L, P·M + P·K); recv_pos (L, n_per, P); slot_pos (L, E_p).
    """

    rows_b: List[torch.Tensor]
    cols_b: List[torch.Tensor]
    epos_b: List[torch.Tensor]
    row_pos: torch.Tensor
    rows_t_b: List[torch.Tensor]
    cols_t_b: List[torch.Tensor]
    epos_t_b: List[torch.Tensor]
    row_pos_t: torch.Tensor
    halo_pos_t: torch.Tensor
    recv_pos: torch.Tensor
    slot_pos: torch.Tensor
    twin_pos_t: List[torch.Tensor]
    widths: tuple
    n_bnd: tuple
    n_halo_t: tuple
    total_rows: int
    total_rows_t: int
    halo_rows_t: int
    n_per: int
    axis: str
    host: HaloEllHost = dataclasses.field(repr=False)

    @property
    def route(self) -> str:
        return self.host.route


def _rank_within(key, order_extra=None):
    """Per-element rank inside its ``key`` group (0-based); ties broken by
    ``order_extra`` then position (stable)."""
    if order_extra is None:
        order = np.argsort(key, kind="stable")
    else:
        order = np.lexsort((order_extra, key))
    ks = key[order]
    new_grp = np.concatenate([[True], ks[1:] != ks[:-1]])
    grp_id = np.cumsum(new_grp) - 1
    starts = np.flatnonzero(new_grp)
    rank_sorted = np.arange(len(key), dtype=np.int64) - starts[grp_id]
    rank = np.empty(len(key), np.int64)
    rank[order] = rank_sorted
    return rank


def _pack_shared(p, n_rows, s_arr, r_arr, c_arr, pos_arr, widths,
                 spec_of, special_side, pad_row, pad_col, e_p):
    """Vectorised shared-shape degree-bucket packer over P shards.

    Edges come flat: shard ``s_arr``, row ``r_arr`` ∈ [0, n_rows), col
    ``c_arr``, slot position ``pos_arr``. ``spec_of(row_keys)`` marks the
    special rows (key = s·n_rows + r), placed in a fixed-size tail
    (``special_side='tail'``) or head (``'head'``) section of their
    bucket, sized by the largest shard.

    Returns (rows_b, cols_b, epos_b, row_pos, splits, bucket_widths,
    total_rows, section_pos, total_spec); section_pos maps each row key
    to its position in the concatenation of the special sections (or −1).
    """
    widths = sorted(set(int(w) for w in widths))
    key = s_arr * np.int64(n_rows) + r_arr
    row_keys, deg_row = np.unique(key, return_counts=True)
    max_deg = int(deg_row.max()) if len(deg_row) else 1
    while widths[-1] < max_deg:
        widths.append(widths[-1] * 2)
    wa = np.asarray(widths, np.int64)
    bi_row = np.searchsorted(wa, deg_row, side="left")
    s_row = row_keys // n_rows
    spec_row = spec_of(row_keys)

    bs = bi_row * p + s_row
    cnt_bs = np.bincount(bs, minlength=len(widths) * p).reshape(-1, p)
    spec_bs = np.bincount(bs[spec_row],
                          minlength=len(widths) * p).reshape(-1, p)
    nonspec_bs = cnt_bs - spec_bs
    keep = np.flatnonzero(cnt_bs.sum(axis=1) > 0)
    n_spec_b = spec_bs.max(axis=1)
    r_pad_b = np.zeros(len(widths), np.int64)
    r_pad_b[keep] = [
        _round_up(int(nonspec_bs[i].max() + n_spec_b[i]), 8) for i in keep
    ]

    rank_spec = _rank_within(np.where(spec_row, bs, -1), row_keys)
    rank_non = _rank_within(np.where(~spec_row, bs, -1), row_keys)
    slot = np.empty(len(row_keys), np.int64)
    if special_side == "tail":
        slot[~spec_row] = rank_non[~spec_row]
        sp = spec_row
        slot[sp] = (r_pad_b[bi_row[sp]] - spec_bs[bi_row[sp], s_row[sp]]
                    + rank_spec[sp])
    else:
        slot[spec_row] = rank_spec[spec_row]
        ns = ~spec_row
        slot[ns] = n_spec_b[bi_row[ns]] + rank_non[ns]

    bucket_base = np.zeros(len(widths) + 1, np.int64)
    np.cumsum(r_pad_b, out=bucket_base[1:])
    total_rows = int(bucket_base[-1])
    row_pos = np.full((p, n_rows), total_rows, np.int64)
    row_pos[s_row, row_keys % n_rows] = bucket_base[bi_row] + slot

    spec_base = np.zeros(len(widths) + 1, np.int64)
    np.cumsum(n_spec_b, out=spec_base[1:])
    section_pos = np.full((p, n_rows), -1, np.int64)
    sp = spec_row
    section_pos[s_row[sp], row_keys[sp] % n_rows] = \
        spec_base[bi_row[sp]] + slot[sp] - (
            0 if special_side == "head"
            else (bucket_base[bi_row[sp] + 1] - bucket_base[bi_row[sp]]
                  - n_spec_b[bi_row[sp]]))
    total_spec = int(spec_base[-1])

    k_arr = _rank_within(key, pos_arr)

    bi_edge = bi_row[np.searchsorted(row_keys, key)]
    rows_b, cols_b, epos_b, bw, splits = [], [], [], [], []
    for i in keep:
        w = widths[i]
        r_pad = int(r_pad_b[i])
        rows = np.full((p, r_pad), pad_row, np.int32)
        cols = np.full((p, r_pad, w), pad_col, np.int32)
        epos = np.full((p, r_pad, w), e_p, np.int32)
        rsel = bi_row == i
        rows[s_row[rsel], slot[rsel]] = (row_keys[rsel] % n_rows).astype(
            np.int32)
        esel = bi_edge == i
        ek = key[esel]
        ri = np.searchsorted(row_keys, ek)
        cols[s_arr[esel], slot[ri], k_arr[esel]] = c_arr[esel].astype(
            np.int32)
        epos[s_arr[esel], slot[ri], k_arr[esel]] = pos_arr[esel].astype(
            np.int32)
        rows_b.append(rows)
        cols_b.append(cols)
        epos_b.append(epos)
        bw.append(w)
        splits.append(int(n_spec_b[i]))
    return (rows_b, cols_b, epos_b, row_pos, splits, bw, total_rows,
            section_pos, total_spec)


def _pack_both(src_ext, dst_loc, p, n_per, n_ext, e_p, widths):
    """Both shared-shape packings of the per-shard edges ``(P, e_p)``: the
    dst packing (rows local dst, cols extended src; boundary rows in a
    tail) and the transpose (rows extended src, cols local dst; halo rows
    in a head), as :func:`_pack_shared` tuples, with ``slot_pos`` (each
    slot's position in the dst buckets' flat concatenation) and the route
    that built them: the native packer (two counting passes over the plan
    matrices) where the library builds, else numpy, with the same
    arrays."""
    from custom_op_benchmark_tpu_torch.graph import native

    nat0 = native.halo_pack_native(
        dst_loc, src_ext, dst_loc, n_per, p, n_per, widths, spec_mode=0,
        spec_thresh=n_per, special_side="tail", pad_row=n_per,
        pad_col=n_per, want_slot_pos=True)
    nat1 = None
    if nat0 is not None:
        nat1 = native.halo_pack_native(
            src_ext, dst_loc, dst_loc, n_per, p, n_ext, widths, spec_mode=1,
            spec_thresh=n_per + 1, special_side="head", pad_row=n_ext,
            pad_col=n_per, want_section_pos=True)
    if nat0 is not None and nat1 is not None:
        return nat0[:9], nat1[:9], nat0[9], "native"
    s_all = np.repeat(np.arange(p, dtype=np.int64), e_p)
    pos_all = np.tile(np.arange(e_p, dtype=np.int64), p)
    dl = dst_loc.reshape(-1).astype(np.int64)
    se = src_ext.reshape(-1).astype(np.int64)
    real = dl < n_per
    s_arr, pos_arr = s_all[real], pos_all[real]
    dl_r, se_r = dl[real], se[real]
    # dst packing: boundary rows have an in-edge from a halo col.
    bnd_keys = np.unique((s_arr * np.int64(n_per) + dl_r)[se_r > n_per])
    dst_pack = _pack_shared(
        p, n_per, s_arr, dl_r, se_r, pos_arr, widths,
        lambda rk: np.isin(rk, bnd_keys, assume_unique=True),
        "tail", n_per, n_per, e_p)
    # transpose packing: rows = extended src, cols = local dst.
    t_pack = _pack_shared(
        p, n_ext, s_arr, se_r, dl_r, pos_arr, widths,
        lambda rk: (rk % n_ext) >= n_per + 1, "head", n_ext, n_per, e_p)
    # slot → bucket-flat position (the inverse of epos_b).
    epos_b = dst_pack[2]
    total_flat = sum(int(np.prod(e_.shape[1:])) for e_ in epos_b)
    slot_pos = np.full((p, e_p), total_flat, np.int64)
    base = 0
    for epos in epos_b:
        r_pad, w = epos.shape[1:]
        ee = epos.reshape(p, -1)
        valid = ee < e_p
        srep = np.repeat(np.arange(p), r_pad * w).reshape(p, -1)
        flat = np.tile(np.arange(r_pad * w), (p, 1))
        slot_pos[srep[valid], ee[valid]] = base + flat[valid]
        base += r_pad * w
    return dst_pack, t_pack, slot_pos, "numpy"


def halo_ell_host(host: HaloPlanHost,
                  widths=DEFAULT_WIDTHS) -> HaloEllHost:
    """Pack each shard's local (src_ext, dst_loc) edges into shared-shape
    degree buckets, with the overlap sections: both packings by the native
    packer (two counting passes over the plan matrices) when the library
    builds, else by numpy, with the same arrays."""
    p, n_per = host.num_parts, host.n_per
    src_ext, dst_loc = host.src_ext, host.dst_loc
    e_p = host.edges_per_part
    n_ext = n_per + 1 + p * host.halo + p * host.n_hub

    dst_pack, t_pack, slot_pos, route = _pack_both(src_ext, dst_loc, p, n_per,
                                                   n_ext, e_p, widths)
    (rows_b, cols_b, epos_b, row_pos, n_bnd, bw, total_rows, _,
     _) = dst_pack
    (rows_t_b, cols_t_b, epos_t_b, row_pos_t, n_halo_t, _, total_rows_t,
     section_pos_t, halo_rows_t) = t_pack

    # halo_pos_t: extended halo id n_per+1+j → halo-section position.
    halo_pos_t = section_pos_t[:, n_per + 1:].copy()
    halo_pos_t[halo_pos_t < 0] = halo_rows_t

    # twin_pos_t = slot_pos ∘ epos_t (pad slots land on the zero entry).
    total_flat = sum(int(np.prod(np.asarray(e_).shape[1:]))
                     for e_ in epos_b)
    sp_pad = np.concatenate(
        [np.asarray(slot_pos),
         np.full((p, 1), total_flat, np.asarray(slot_pos).dtype)], axis=1)
    twin_pos_t = []
    for ep in epos_t_b:
        ep = np.asarray(ep)
        tw = np.take_along_axis(
            sp_pad, ep.reshape(p, -1).astype(np.int64), axis=1
        ).reshape(ep.shape)
        twin_pos_t.append(tw.astype(np.int32, copy=False))

    i32 = np.int32
    return HaloEllHost(
        rows_b=list(rows_b), cols_b=list(cols_b), epos_b=list(epos_b),
        row_pos=np.asarray(row_pos).astype(i32, copy=False),
        rows_t_b=list(rows_t_b), cols_t_b=list(cols_t_b),
        epos_t_b=list(epos_t_b),
        row_pos_t=np.asarray(row_pos_t).astype(i32, copy=False),
        halo_pos_t=halo_pos_t.astype(i32, copy=False),
        recv_pos=host.recv_pos,
        slot_pos=np.asarray(slot_pos).astype(i32, copy=False),
        twin_pos_t=twin_pos_t, widths=tuple(bw), n_bnd=tuple(n_bnd),
        n_halo_t=tuple(n_halo_t), total_rows=int(total_rows),
        total_rows_t=int(total_rows_t), halo_rows_t=int(halo_rows_t),
        n_per=n_per, route=route)


def place_ell(eh: HaloEllHost, mesh: Mesh, axis: str = "edge") -> HaloEll:
    def put(a):
        return shard_rows(mesh, a, axis)

    return HaloEll(
        rows_b=[put(a) for a in eh.rows_b],
        cols_b=[put(a) for a in eh.cols_b],
        epos_b=[put(a) for a in eh.epos_b], row_pos=put(eh.row_pos),
        rows_t_b=[put(a) for a in eh.rows_t_b],
        cols_t_b=[put(a) for a in eh.cols_t_b],
        epos_t_b=[put(a) for a in eh.epos_t_b],
        row_pos_t=put(eh.row_pos_t), halo_pos_t=put(eh.halo_pos_t),
        recv_pos=put(eh.recv_pos), slot_pos=put(eh.slot_pos),
        twin_pos_t=[put(a) for a in eh.twin_pos_t], widths=eh.widths,
        n_bnd=eh.n_bnd, n_halo_t=eh.n_halo_t, total_rows=eh.total_rows,
        total_rows_t=eh.total_rows_t, halo_rows_t=eh.halo_rows_t,
        n_per=eh.n_per, axis=axis, host=eh)


def halo_ell(hg: HaloGraph, mesh: Mesh, widths=DEFAULT_WIDTHS) -> HaloEll:
    """Pack ``hg``'s per-shard edges (see :func:`halo_ell_host`) and place
    the packing on ``mesh``."""
    return place_ell(halo_ell_host(hg.host, widths), mesh, hg.axis)


# ---------------------------------------------------------------------------
# halo_attention_ell: the fused attention with the hand VJP
# ---------------------------------------------------------------------------

def _sections(n_rows: int, n_special: int, side: str):
    """The (interior or local, boundary or halo) row ranges of a bucket."""
    cut = n_rows - n_special if side == "tail" else n_special
    return slice(0, cut), slice(cut, n_rows)


def _attn_go(qp, kt, vt, r, c, n_per, h, d, scale, dtype):
    """One section: scores, α (L, R, D, h) and out (L, R, h·d) in ``dtype``,
    f32 inside."""
    kg = take_raw(kt, c).float().unflatten(-1, (h, d))
    vg = take_raw(vt, c).float().unflatten(-1, (h, d))
    qr = take_raw(qp, r).float().unflatten(-1, (h, d))
    s = torch.einsum("lrhd,lrkhd->lrkh", qr, kg) * scale
    mask = (c != n_per)[..., None]
    sm = torch.where(mask, s, MASK_VALUE)
    m = sm.amax(2, keepdim=True)
    z = torch.where(mask, torch.exp(sm - m), 0.0)
    alpha = z / z.sum(2, keepdim=True).clamp(min=DENOM_FLOOR)
    out = torch.einsum("lrkh,lrkhd->lrhd", alpha, vg).flatten(2)
    return out.to(dtype), alpha


def _pad1(x: torch.Tensor) -> torch.Tensor:
    """(L, n, ...) → (L, n+1, ...) with a zero row appended."""
    return torch.cat([x, x.new_zeros((x.shape[0], 1) + tuple(x.shape[2:]))],
                     1)


def _cat_rows(parts: List[torch.Tensor], n_l: int, width, dtype,
              device) -> torch.Tensor:
    """Section outputs ``(L, R_i, ...)`` in packed-row order, then a zero
    row: the table ``row_pos`` gathers from."""
    zero = torch.zeros((n_l, 1) + tuple(width), dtype=dtype, device=device)
    return torch.cat([p.to(dtype) for p in parts] + [zero], 1)


class _HaloAttnEll(Function):
    @staticmethod
    def forward(ctx, mesh, hg, he, q3, k3, v3):
        n_l, n_per = q3.shape[0] // hg.n_per, hg.n_per
        h, d = q3.shape[1], q3.shape[2]
        hd = h * d
        scale = 1.0 / math.sqrt(d)
        q2, k2, v2 = (t.reshape(n_l, n_per, hd) for t in (q3, k3, v3))
        ex_k, ex_v = _Exchange(mesh, hg, k2), _Exchange(mesh, hg, v2)
        qp = _pad1(q2)
        bucket_secs = [_sections(r.shape[1], nb, "tail")
                       for r, nb in zip(he.rows_b, he.n_bnd)]
        # Interior sections read the local tables while the exchange runs.
        res = {}
        for i, (rows, cols) in enumerate(zip(he.rows_b, he.cols_b)):
            sec = bucket_secs[i][0]
            if sec.stop > sec.start:
                res[i, 0] = _attn_go(qp, ex_k.xp, ex_v.xp, rows[:, sec],
                                     cols[:, sec], n_per, h, d, scale,
                                     q3.dtype)
        k_ext, v_ext = ex_k.ext(), ex_v.ext()
        for i, (rows, cols) in enumerate(zip(he.rows_b, he.cols_b)):
            sec = bucket_secs[i][1]
            if sec.stop > sec.start:
                res[i, 1] = _attn_go(qp, k_ext, v_ext, rows[:, sec],
                                     cols[:, sec], n_per, h, d, scale,
                                     q3.dtype)
        outs, alphas = [], []
        for i in range(len(he.rows_b)):
            secs = [res[i, j] for j in (0, 1) if (i, j) in res]
            outs += [o for o, _ in secs]
            alphas.append(torch.cat([a for _, a in secs], 1))
        out = take_raw(_cat_rows(outs, n_l, (hd,), q3.dtype, q3.device),
                       he.row_pos)
        ctx.mesh, ctx.graphs, ctx.shape = mesh, (hg, he), (n_l, h, d)
        ctx.save_for_backward(q3, k3, v3, *alphas)
        return out.reshape(q3.shape)

    @staticmethod
    def backward(ctx, dy):
        mesh = ctx.mesh
        hg, he = ctx.graphs
        n_l, h, d = ctx.shape
        q3, k3, v3, *alphas = ctx.saved_tensors
        n_per, hd = hg.n_per, h * d
        scale = 1.0 / math.sqrt(d)
        q2, k2, v2 = (t.reshape(n_l, n_per, hd) for t in (q3, k3, v3))
        ex_k, ex_v = _Exchange(mesh, hg, k2), _Exchange(mesh, hg, v2)
        qp = _pad1(q2)
        dyp = _pad1(dy.reshape(n_l, n_per, hd).to(q3.dtype))

        def p1(r, c, alpha, kt, vt):
            kg = take_raw(kt, c).float().unflatten(-1, (h, d))
            vg = take_raw(vt, c).float().unflatten(-1, (h, d))
            dyr = take_raw(dyp, r).float().unflatten(-1, (h, d))
            dalpha = torch.einsum("lrhd,lrkhd->lrkh", dyr, vg)
            agg = (alpha * dalpha).sum(2, keepdim=True)
            dS = alpha * (dalpha - agg) * scale
            dq = torch.einsum("lrkh,lrkhd->lrhd", dS, kg).flatten(2)
            return dq, torch.cat([alpha, dS], -1)

        # pass 1 (local dst buckets): dq and the packed (α, dS); interior
        # sections read the local tables while the exchange runs.
        res = {}
        secs_b = [_sections(r.shape[1], nb, "tail")
                  for r, nb in zip(he.rows_b, he.n_bnd)]
        for j in (0, 1):
            kt, vt = (ex_k.xp, ex_v.xp) if j == 0 else (ex_k.ext(),
                                                        ex_v.ext())
            for i, (rows, cols, al) in enumerate(zip(he.rows_b, he.cols_b,
                                                     alphas)):
                sec = secs_b[i][j]
                if sec.stop > sec.start:
                    res[i, j] = p1(rows[:, sec], cols[:, sec], al[:, sec],
                                   kt, vt)
        dq_parts, packed = [], []
        for i in range(len(he.rows_b)):
            secs = [res[i, j] for j in (0, 1) if (i, j) in res]
            dq_parts += [a for a, _ in secs]
            packed.append(torch.cat([b for _, b in secs], 1)
                          .reshape(n_l, -1, 2 * h))
        del res
        f32, dev = torch.float32, q3.device
        dq = take_raw(_cat_rows(dq_parts, n_l, (hd,), f32, dev), he.row_pos)
        # The twin hop: local-bucket (α, dS) to the transpose slots.
        packed_flat = _cat_rows(packed, n_l, (2 * h,), f32, dev)
        del packed

        def p2(ct, bt):
            q_c = take_raw(qp, ct).float().unflatten(-1, (h, d))
            dy_c = take_raw(dyp, ct).float().unflatten(-1, (h, d))
            dk = torch.einsum("lrkh,lrkhd->lrhd", bt[..., h:], q_c)
            dv = torch.einsum("lrkh,lrkhd->lrhd", bt[..., :h], dy_c)
            return torch.cat([dk.flatten(2), dv.flatten(2)], -1)

        # pass 2 (transpose buckets): the halo heads first, whose rows
        # start the reverse exchange, then the local tails.
        secs_t = [_sections(c.shape[1], nh, "head")
                  for c, nh in zip(he.cols_t_b, he.n_halo_t)]
        heads, tails = {}, {}
        for i, (ct, tw) in enumerate(zip(he.cols_t_b, he.twin_pos_t)):
            sec = secs_t[i][0]
            if sec.stop > sec.start:
                heads[i] = p2(ct[:, sec], take_raw(packed_flat, tw[:, sec]))
        zero_w = (2 * hd,)
        halo_parts = [heads[i] for i in sorted(heads)]
        dkv_halo = take_raw(_cat_rows(halo_parts, n_l, zero_w, f32, dev),
                            he.halo_pos_t).to(k3.dtype)
        ret = _Return(mesh, hg, dkv_halo)
        for i, (ct, tw) in enumerate(zip(he.cols_t_b, he.twin_pos_t)):
            sec = secs_t[i][1]
            if sec.stop > sec.start:
                tails[i] = p2(ct[:, sec], take_raw(packed_flat, tw[:, sec]))
        all_parts = []
        for i in range(len(he.cols_t_b)):
            all_parts += [part[i] for part in (heads, tails) if i in part]
        dkv_local = take_raw(_cat_rows(all_parts, n_l, zero_w, f32, dev),
                             he.row_pos_t[:, :n_per])
        dkv = ret.land(dkv_local)
        shp = q3.shape
        return (None, None, None, dq.reshape(shp).to(q3.dtype),
                dkv[..., :hd].reshape(shp).to(k3.dtype),
                dkv[..., hd:].reshape(shp).to(v3.dtype))


def halo_attention_ell(hg: HaloGraph, he: HaloEll, mesh: Mesh, q, k, v, *,
                       head_axis: str = None):
    """Distributed fused attention: the halo exchange and per-shard ELL
    bucket sweeps, no scatter forward or backward, the exchange beside the
    interior sweeps. q, k, v: ``(P·n_per, h, d)`` or ``(P·n_per, d)``,
    node-sharded.

    The hand VJP is the distributed form of the single-device ELL
    attention's: pass 1 on the local dst buckets (α from the forward's
    residual, dq and the packed (α, dS)); the twin hop through
    ``twin_pos_t``; pass 2 on the transpose buckets over extended source
    rows (dk‖dv per extended row); the halo rows' dk‖dv go back with one
    reverse exchange in the operands' dtype and land in f32.

    ``head_axis``: a second mesh axis that splits the heads (a 2-D edge ×
    head mesh). On the process mesh each rank holds its ``h/T`` heads and
    the exchange moves only those; heads are independent through the op,
    so the local mesh keeps the head axis as a view and computes every
    head at once.
    """
    squeeze = q.dim() == 2
    q3, k3, v3 = ((t[:, None] if squeeze else t) for t in (q, k, v))
    if head_axis is not None and mesh.is_local and \
            q3.shape[1] % mesh.shape[head_axis]:
        raise ValueError(f"heads {q3.shape[1]} not divisible by the "
                         f"{head_axis!r} axis ({mesh.shape[head_axis]})")
    _check_rows(hg, mesh, q3)
    y = _HaloAttnEll.apply(mesh, hg, he, q3.contiguous(), k3.contiguous(),
                           v3.contiguous())
    return y[:, 0] if squeeze else y


# ---------------------------------------------------------------------------
# halo_spmm_ell: the weighted SpMM with the hand VJP
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HaloPackedWeights:
    """Edge weights in both per-shard ELL layouts: ``local[i]`` has bucket
    i's ``(L, R, D)`` shape in the dst packing, ``t[i]`` in the transpose
    packing, so halo_spmm_ell skips the per-step slot gathers of the
    weights forward and backward."""

    local: list
    t: list


def halo_pack_weights(hg: HaloGraph, he: HaloEll, mesh: Mesh,
                      edata_canonical) -> HaloPackedWeights:
    """Canonical ``(E_pad,)`` weights → packed per shard (cold path)."""
    ed = blocks(mesh, hg.axis, halo_edge_data(hg, mesh, edata_canonical))
    edp = _pad1(ed)
    return HaloPackedWeights(local=[take_raw(edp, e) for e in he.epos_b],
                             t=[take_raw(edp, e) for e in he.epos_t_b])


def _wsum(w, xg):
    """Σ_k w[l, r, k]·xg[l, r, k, :] in f32."""
    return torch.einsum("lrk,lrkd->lrd", w.float(), xg.float())


def _wdot(a, xg):
    """<a[l, r], xg[l, r, k]> in f32."""
    return torch.einsum("lrd,lrkd->lrk", a.float(), xg.float())


class _HaloSpmmEll(Function):
    """``packed`` False: ``ws`` is one ``(L, E_p)`` edge array in slot
    order. True: the dst-packed pieces, then the transpose-packed ones."""

    @staticmethod
    def forward(ctx, mesh, hg, he, packed, n_local, x, *ws):
        ex = _Exchange(mesh, hg, x)
        if packed:
            w_b = ws[:n_local]
        else:
            edp = _pad1(ws[0])
            w_b = [take_raw(edp, e) for e in he.epos_b]
        secs_b = [_sections(r.shape[1], nb, "tail")
                  for r, nb in zip(he.rows_b, he.n_bnd)]
        res = {}
        for j in (0, 1):
            xt = ex.xp if j == 0 else ex.ext()
            for i, cols in enumerate(he.cols_b):
                sec = secs_b[i][j]
                if sec.stop > sec.start:
                    res[i, j] = _wsum(w_b[i][:, sec], take_raw(
                        xt, cols[:, sec])).to(x.dtype)
        outs = [res[i, j] for i in range(len(he.cols_b)) for j in (0, 1)
                if (i, j) in res]
        ctx.mesh, ctx.graphs = mesh, (hg, he)
        ctx.packed, ctx.n_local = packed, n_local
        ctx.save_for_backward(x, *ws)
        return take_raw(_cat_rows(outs, x.shape[0], x.shape[2:], x.dtype,
                                  x.device), he.row_pos)

    @staticmethod
    def backward(ctx, dy):
        mesh = ctx.mesh
        hg, he = ctx.graphs
        x, *ws = ctx.saved_tensors
        n_l, n_per, d = x.shape[0], hg.n_per, x.shape[-1]
        f32, dev = torch.float32, x.device
        ex = _Exchange(mesh, hg, x)
        dyp = _pad1(dy.to(x.dtype))
        if ctx.packed:
            w_t = ws[ctx.n_local:]
        else:
            edp = _pad1(ws[0])
            w_t = [take_raw(edp, e) for e in he.epos_t_b]

        # The weights' cotangent in the dst layout: <dy[row], x[col]>;
        # interior sections read the local table.
        secs_b = [_sections(r.shape[1], nb, "tail")
                  for r, nb in zip(he.rows_b, he.n_bnd)]
        dd = {}
        for j in (0, 1):
            xt = ex.xp if j == 0 else ex.ext()
            for i, (rows, cols) in enumerate(zip(he.rows_b, he.cols_b)):
                sec = secs_b[i][j]
                if sec.stop > sec.start:
                    dd[i, j] = _wdot(take_raw(dyp, rows[:, sec].clamp(
                        max=n_per)), take_raw(xt, cols[:, sec]))
        dwl = [torch.cat([dd[i, j] for j in (0, 1) if (i, j) in dd], 1)
               for i in range(len(he.rows_b))]
        del dd
        x_ext = ex.ext()

        def p2(rt, ct, wt):
            dy_c = take_raw(dyp, ct)
            dx = _wsum(wt, dy_c)
            if not ctx.packed:
                return dx, None
            xr = take_raw(x_ext, rt.clamp(max=x_ext.shape[1] - 1))
            return dx, _wdot(xr, dy_c)

        secs_t = [_sections(c.shape[1], nh, "head")
                  for c, nh in zip(he.cols_t_b, he.n_halo_t)]
        heads, tails = {}, {}
        for i, (rt, ct) in enumerate(zip(he.rows_t_b, he.cols_t_b)):
            sec = secs_t[i][0]
            if sec.stop > sec.start:
                heads[i] = p2(rt[:, sec], ct[:, sec], w_t[i][:, sec])
        zero_w = (d,)
        halo_parts = [heads[i][0] for i in sorted(heads)]
        dx_halo = take_raw(_cat_rows(halo_parts, n_l, zero_w, f32, dev),
                           he.halo_pos_t).to(x.dtype)
        ret = _Return(mesh, hg, dx_halo)
        for i, (rt, ct) in enumerate(zip(he.rows_t_b, he.cols_t_b)):
            sec = secs_t[i][1]
            if sec.stop > sec.start:
                tails[i] = p2(rt[:, sec], ct[:, sec], w_t[i][:, sec])
        all_parts, dwt = [], []
        for i in range(len(he.cols_t_b)):
            secs = [part[i] for part in (heads, tails) if i in part]
            all_parts += [a for a, _ in secs]
            if ctx.packed:
                dwt.append(torch.cat([b for _, b in secs], 1))
        dx_local = take_raw(_cat_rows(all_parts, n_l, zero_w, f32, dev),
                            he.row_pos_t[:, :n_per])
        dx = ret.land(dx_local).to(x.dtype)
        if ctx.packed:
            dws = [g.to(w.dtype) for g, w in zip(dwl + dwt, ws)]
        else:
            flat = torch.cat([t.reshape(t.shape[0], -1) for t in dwl]
                             + [dwl[0].new_zeros((dwl[0].shape[0], 1))], 1)
            dws = [take_raw(flat, he.slot_pos).to(ws[0].dtype)]
        return (None, None, None, None, None, dx, *dws)


def halo_spmm_ell(hg: HaloGraph, he: HaloEll, mesh: Mesh, edata, x):
    """Weighted SpMM with the halo exchange and scatter-free per-shard ELL
    sweeps (the fast counterpart of :func:`halo_spmm`). ``edata``:
    ``(P·E_p,)`` in slot order (:func:`halo_edge_data`), or a
    :class:`HaloPackedWeights` (its cotangents come back packed, both
    copies); x: ``(P·n_per, d)``. The VJP: the weights' cotangent through
    the ``slot_pos`` gather (or packed), dx through the transpose buckets
    and the reverse exchange."""
    _check_rows(hg, mesh, x)
    xb = blocks(mesh, hg.axis, x).contiguous()
    if isinstance(edata, HaloPackedWeights):
        ws = list(edata.local) + list(edata.t)
        y = _HaloSpmmEll.apply(mesh, hg, he, True, len(edata.local), xb,
                               *ws)
    else:
        y = _HaloSpmmEll.apply(mesh, hg, he, False, 0, xb,
                               blocks(mesh, hg.axis, edata).contiguous())
    return unblocks(y)


def plan_summary(hg: HaloGraph, he: Optional[HaloEll] = None) -> dict:
    """The plan's communication numbers: halo fraction, the real and padded
    rows of one exchange, and (with ``he``) the interior row share."""
    host = hg.host
    p = hg.num_parts
    hub_rows = int((host.hub_idx < hg.n_per).sum()) * (p - 1)
    out = dict(
        num_parts=p, n_per=hg.n_per, halo=hg.halo, n_hub=hg.n_hub,
        hub_threshold=host.hub_threshold, route=hg.route,
        halo_fraction=hg.halo_fraction,
        exchange_rows_real=int((host.send_idx < hg.n_per).sum()) + hub_rows,
        exchange_rows_padded=hg.comm_bytes_per_exchange,
        edges_per_part=hg.edges_per_part)
    if he is not None:
        total = sum(int(r.shape[1]) for r in he.host.rows_b)
        out["interior_row_share"] = 1 - sum(he.n_bnd) / max(total, 1)
        out["ell_route"] = he.route
    return out


__all__ = ["HaloEll", "HaloGraph", "HaloPackedWeights", "HaloPlanHost",
           "PlanStats", "halo_attention_ell", "halo_edge_data", "halo_ell",
           "halo_gat_attention", "halo_graph", "halo_node_sharding",
           "halo_pack_weights", "halo_spmm", "halo_spmm_ell",
           "plan_stats", "plan_summary", "shard_halo_nodes"]
