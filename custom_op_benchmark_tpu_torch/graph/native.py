"""ctypes binding of the port's graphcore library, with numpy equivalents.

Counterpart of custom_op_benchmark_tpu/graph/native.py for the entry
points the port uses: the dual-CSR build (``from_coo``), the row
chunking (``partition_csr``), union-find components (``reorder``), the
ELL packer (``ell_pack``), the neighbour samplers (``data/sampling.py``)
and the halo planner and packer (``parallel/halo.py``).

The library is the port's own copy of the C++ source
(``custom_op_benchmark_tpu_torch/csrc/graphcore.cpp``). ``g++`` builds it
at first use into ``build/graphcore/`` at the repository root, under a
name keyed on a hash of the source and the flags, so a changed source
builds anew and a stale library never shadows it. The build writes a
temporary file and renames it into place, so processes that build at
once (test workers) never load a half-written library.

Every entry point has a numpy equivalent in its caller, which runs when
the library cannot be built (no compiler): each function here returns
None then, and :func:`available` says which path runs. The builds give
the same arrays on both paths; the samplers' numpy path draws from
another generator, as the reference's does, so it samples other edges.
Each entry point counts its native calls in ``<function>.calls``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "graphcore.cpp"
BUILD_DIR = _PKG.parent / "build" / "graphcore"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I64 = ctypes.c_int64
_SIGNATURES = {
    "graphcore_build_dual_csr": (ctypes.c_int32, [
        _I64P, _I64P, _I64, _I64, _I32P, _I32P, _I32P, _I32P, _I32P, _I32P]),
    "graphcore_partition_csr": (_I64, [
        _I32P, _I64, ctypes.c_int32, _I32P, _I32P]),
    "graphcore_connected_components": (_I64, [
        _I32P, _I32P, _I64, _I64, _I32P]),
    "graphcore_ell_pack": (_I64, [
        _I32P, _I64, _I32P, _I64P, _I64, _I64P, _I64, _I64, _I64P,
        _I32P, _I32P, _I32P, _I32P, _I64P]),
    "graphcore_sample_in_edges": (_I64, [
        _I32P, _I32P, _I64, _I32P, _I64, ctypes.c_int32, ctypes.c_uint64,
        _I32P, _I32P]),
    "graphcore_sample_subgraph": (_I64, [
        _I32P, _I32P, _I64, _I32P, _I64, _I32P, _I64, ctypes.c_uint64,
        ctypes.c_int32, _I64, _I64, ctypes.c_int32, ctypes.c_int32,
        _I32P, _I32P, _I32P, _I32P, _I64P]),
    "graphcore_halo_plan": (_I64, [
        _I32P, _I32P, _I64, _I64, _I64, _I64, _I64, _I64, _I64P, _I32P,
        _I32P, _I32P, _I32P]),
    "graphcore_halo_pack": (_I64, [
        _I32P, _I32P, _I32P, _I64, _I64, _I64, _I64, _I64P, _I64P, _I64,
        ctypes.c_int32, _I64, ctypes.c_int32, _I64, _I64, _I64, _I64P,
        _I64P, _I32P, _I32P, _I32P, _I32P, _I32P, _I32P]),
}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libgraphcore_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless one for this source exists; returns its
    path. Raises with the compiler's output if the build fails."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("cannot build graphcore: no g++ or c++ on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, or None when it cannot be built here."""
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError):
        return None
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def available() -> bool:
    """True when the native library runs, False when the numpy
    equivalents do."""
    return _load() is not None


def _p32(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def _p64(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def build_dual_csr(src, dst, n_nodes: int):
    """Canonical (src, dst) sort and the dual CSR. Returns (src_c, dst_c,
    indptr_r, csc_perm, csc_perm_inv, indptr_c) as int32 (the indptrs
    n_nodes + 2 long), or None without the library."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    e = len(src)
    src_c, dst_c, csc_perm, csc_perm_inv = (np.empty(e, np.int32)
                                            for _ in range(4))
    indptr_r, indptr_c = (np.empty(n_nodes + 2, np.int32) for _ in range(2))
    rc = lib.graphcore_build_dual_csr(
        _p64(src), _p64(dst), e, n_nodes, _p32(src_c), _p32(dst_c),
        _p32(indptr_r), _p32(csc_perm), _p32(csc_perm_inv), _p32(indptr_c))
    if rc != 0:
        raise ValueError(f"graphcore_build_dual_csr failed: rc={rc}")
    build_dual_csr.calls += 1
    return src_c, dst_c, indptr_r, csc_perm, csc_perm_inv, indptr_c


def partition_csr_native(indptr, chunk_size: int):
    """``partition_csr``'s (row, chunk_indptr), or None."""
    lib = _load()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int32)
    n_rows = len(indptr) - 1
    total = lib.graphcore_partition_csr(_p32(indptr), n_rows, chunk_size,
                                        None, None)
    row = np.empty(total, np.int32)
    cptr = np.empty(total + 1, np.int32)
    lib.graphcore_partition_csr(_p32(indptr), n_rows, chunk_size, _p32(row),
                                _p32(cptr))
    partition_csr_native.calls += 1
    return row, cptr


def connected_components_native(src, dst, n_nodes: int):
    """Union-find component labels, the root id the union by size picks
    per node (int32), or None."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    labels = np.empty(n_nodes, np.int32)
    lib.graphcore_connected_components(_p32(src), _p32(dst), len(src),
                                       n_nodes, _p32(labels))
    connected_components_native.calls += 1
    return labels


def ell_pack_native(indptr, cols_all, eids_all, n_nodes: int, e_pad: int,
                    widths, row_pad: int):
    """The degree-bucketed ELL packing of one direction (graph/ell.py's
    contract): (bucket_rows, rows_flat, cols_flat, eid_flat, row_pos,
    edge_pos) with the buckets' arrays concatenated in width order, or
    None without the library or where the packing needs more than int32
    indices. ``widths`` must cover the largest degree."""
    lib = _load()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int32)
    cols_all = np.ascontiguousarray(cols_all, np.int32)
    eids_all = np.ascontiguousarray(eids_all, np.int64)
    widths = np.ascontiguousarray(widths, np.int64)
    nw = len(widths)
    bucket_rows = np.zeros(nw, np.int64)
    null32, null64 = _I32P(), _I64P()
    args = (_p32(indptr), n_nodes, _p32(cols_all), _p64(eids_all), e_pad,
            _p64(widths), nw, row_pad, _p64(bucket_rows))
    if lib.graphcore_ell_pack(*args, null32, null32, null32, null32,
                              null64) < 0:
        return None
    rows_flat = np.empty(int(bucket_rows.sum()), np.int32)
    n_slots = int((bucket_rows * widths).sum())
    cols_flat, eid_flat = np.empty(n_slots, np.int32), np.empty(n_slots,
                                                                np.int32)
    row_pos = np.empty(n_nodes, np.int32)
    edge_pos = np.empty(e_pad, np.int64)
    if lib.graphcore_ell_pack(*args, _p32(rows_flat), _p32(cols_flat),
                              _p32(eid_flat), _p32(row_pos),
                              _p64(edge_pos)) < 0:
        return None
    ell_pack_native.calls += 1
    return bucket_rows, rows_flat, cols_flat, eid_flat, row_pos, edge_pos


def sample_in_edges_native(indptr_c, indices_c, n_nodes: int, seeds,
                           fanout: int, seed: int):
    """For each seed, at most ``fanout`` in-edges drawn without replacement
    (all of them where the degree is not larger): ``(src, dst)`` int32, or
    None without the library. ctypes releases the GIL for the call."""
    lib = _load()
    if lib is None:
        return None
    indptr_c = np.ascontiguousarray(indptr_c, np.int32)
    indices_c = np.ascontiguousarray(indices_c, np.int32)
    seeds = np.ascontiguousarray(seeds, np.int32)
    cap = len(seeds) * fanout
    src, dst = np.empty(cap, np.int32), np.empty(cap, np.int32)
    w = lib.graphcore_sample_in_edges(
        _p32(indptr_c), _p32(indices_c), n_nodes, _p32(seeds), len(seeds),
        fanout, seed, _p32(src), _p32(dst))
    sample_in_edges_native.calls += 1
    return src[:w], dst[:w]


def sample_subgraph_native(indptr_c, indices_c, n_nodes: int, seeds,
                           fanouts, seed: int, *, add_self_loops: bool,
                           max_nodes: int, max_edges: int, w: int,
                           n_threads: int = 1):
    """Layered sampling of a whole minibatch (graphcore_sample_subgraph):
    ``(node_ids, n_local, lsrc, ldst, n_edges, in_cols)`` with ``lsrc`` and
    ``ldst`` sized ``max_edges`` (only the first ``n_edges`` hold edges),
    or None without the library or when the call fails. Raises
    AssertionError when a sampled in-degree exceeds ``w``. ctypes
    releases the GIL for the call, so a prefetch thread overlaps it with
    the device's steps."""
    lib = _load()
    if lib is None:
        return None
    indptr_c = np.ascontiguousarray(indptr_c, np.int32)
    indices_c = np.ascontiguousarray(indices_c, np.int32)
    seeds = np.ascontiguousarray(seeds, np.int32)
    fanouts = np.ascontiguousarray(fanouts, np.int32)
    node_ids = np.empty(max_nodes, np.int32)
    lsrc, ldst = np.empty(max_edges, np.int32), np.empty(max_edges, np.int32)
    in_cols = np.empty((max_nodes, int(w)), np.int32)
    n_out = np.zeros(2, np.int64)
    rc = lib.graphcore_sample_subgraph(
        _p32(indptr_c), _p32(indices_c), n_nodes, _p32(seeds), len(seeds),
        _p32(fanouts), len(fanouts), seed, int(add_self_loops), max_nodes,
        max_edges, int(w), int(n_threads), _p32(node_ids), _p32(lsrc),
        _p32(ldst), _p32(in_cols), _p64(n_out))
    if rc == -4:
        raise AssertionError(f"sampled in-degree exceeds the dense-ELL "
                             f"width {w}; sampler invariant broken")
    if rc != 0:
        return None
    sample_subgraph_native.calls += 1
    return node_ids, int(n_out[0]), lsrc, ldst, int(n_out[1]), in_cols


def halo_plan_native(src, dst, n: int, p: int, n_per: int,
                     pad_multiple: int, eid_pad: int):
    """The halo plan without hubs (parallel/halo.py ``halo_plan_host``):
    ``(send_idx (p, p, m), src_ext (p, e_p), dst_loc (p, e_p), eid (p,
    e_p), e_p, m)``, equal to the numpy builder's arrays, or None without
    the library or where the planner declines the shape."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    e = len(src)
    sizes = np.zeros(2, np.int64)
    null32 = _I32P()
    args = (_p32(src), _p32(dst), e, n, p, n_per, pad_multiple, eid_pad,
            _p64(sizes))
    if lib.graphcore_halo_plan(*args, null32, null32, null32, null32) != 0:
        return None
    e_p, m_max = int(sizes[0]), int(sizes[1])
    send_idx = np.empty((p, p, m_max), np.int32)
    src_ext, dst_loc, eid = (np.empty((p, e_p), np.int32) for _ in range(3))
    if lib.graphcore_halo_plan(*args, _p32(send_idx), _p32(src_ext),
                               _p32(dst_loc), _p32(eid)) != 0:
        return None
    halo_plan_native.calls += 1
    return send_idx, src_ext, dst_loc, eid, e_p, m_max


def halo_pack_native(row_mat, col_mat, valid_mat, valid_lt: int, p: int,
                     n_rows: int, widths, spec_mode: int, spec_thresh: int,
                     special_side: str, pad_row: int, pad_col: int,
                     row_pad: int = 8, want_slot_pos=False,
                     want_section_pos=False, nw_cap: int = 48):
    """The shared-shape degree-bucket packer of the halo plan
    (``parallel/halo.py`` ``_pack_shared``), straight off the ``(P, e_p)``
    plan matrices: edge ``(s, j)`` has row ``row_mat[s, j]``, col
    ``col_mat[s, j]`` and slot position ``j``, and is real where ``0 <=
    valid_mat[s, j] < valid_lt``. Returns ``_pack_shared``'s tuple plus
    ``slot_pos`` (None unless asked for), or None without the library or
    where the size guards trip."""
    lib = _load()
    if lib is None:
        return None
    row_mat = np.ascontiguousarray(row_mat, np.int32)
    col_mat = np.ascontiguousarray(col_mat, np.int32)
    valid_mat = np.ascontiguousarray(valid_mat, np.int32)
    e_p = row_mat.shape[1]
    w0 = sorted(set(int(w) for w in widths))
    wbuf = np.zeros(nw_cap, np.int64)
    wbuf[: len(w0)] = w0
    nw_io = np.array([len(w0)], np.int64)
    r_pad_b = np.zeros(nw_cap, np.int64)
    n_spec_b = np.zeros(nw_cap, np.int64)
    side = 0 if special_side == "tail" else 1
    null32 = _I32P()
    head = (_p32(row_mat), _p32(col_mat), _p32(valid_mat), valid_lt, p, e_p,
            n_rows, _p64(wbuf), _p64(nw_io), nw_cap, spec_mode, spec_thresh,
            side, pad_row, pad_col, row_pad, _p64(r_pad_b), _p64(n_spec_b))
    total_rows = lib.graphcore_halo_pack(*head, *([null32] * 6))
    if total_rows < 0:
        return None
    nw = int(nw_io[0])
    wa = wbuf[:nw]
    rows_flat = np.empty(int(p * r_pad_b[:nw].sum()), np.int32)
    n_slots = int(p * (r_pad_b[:nw] * wa).sum())
    cols_flat = np.empty(n_slots, np.int32)
    epos_flat = np.empty(n_slots, np.int32)
    row_pos = np.empty((p, n_rows), np.int32)
    section_pos = (np.empty((p, n_rows), np.int32) if want_section_pos
                   else None)
    slot_pos = np.empty((p, e_p), np.int32) if want_slot_pos else None
    if lib.graphcore_halo_pack(
            *head, _p32(rows_flat), _p32(cols_flat), _p32(epos_flat),
            _p32(row_pos),
            _p32(section_pos) if want_section_pos else null32,
            _p32(slot_pos) if want_slot_pos else null32) < 0:
        return None
    # The flat buckets as the kept (non-empty) per-width arrays.
    rows_b, cols_b, epos_b, bw, splits = [], [], [], [], []
    ro = co = 0
    for i in range(nw):
        rp, w = int(r_pad_b[i]), int(wa[i])
        if rp == 0:
            continue
        rows_b.append(rows_flat[ro:ro + p * rp].reshape(p, rp))
        cols_b.append(cols_flat[co:co + p * rp * w].reshape(p, rp, w))
        epos_b.append(epos_flat[co:co + p * rp * w].reshape(p, rp, w))
        bw.append(w)
        splits.append(int(n_spec_b[i]))
        ro += p * rp
        co += p * rp * w
    halo_pack_native.calls += 1
    return (rows_b, cols_b, epos_b, row_pos, splits, bw, int(total_rows),
            section_pos, int(n_spec_b[:nw].sum()), slot_pos)


ENTRY_POINTS = (build_dual_csr, partition_csr_native,
                connected_components_native, ell_pack_native,
                sample_in_edges_native, sample_subgraph_native,
                halo_plan_native, halo_pack_native)
for _fn in ENTRY_POINTS:
    _fn.calls = 0
