"""The port's graph utilities, native graphcore library and view cache,
against the JAX package.

- ``add_self_loops`` and ``remove_duplicate_edges`` give the JAX package's
  arrays; ``partition_csr``, ``edge_block_rows`` and ``edge_partition``
  its contracts (tests/test_graph.py) and its arrays;
- the native library (the port's own ``csrc/graphcore.cpp``, built with
  g++ into ``build/graphcore/``) gives the same arrays as the numpy path
  and as the JAX package (tests/test_native.py): the dual CSR, the row
  chunks, the components and both ELL packings; the port labels each
  component by its smallest node id on both paths;
- the cache round-trips a view bit for bit, keys by content and refuses
  to unpickle from a directory others can write to (tests/test_cache.py).
"""

import os

import numpy as np
import pytest
import torch

from custom_op_benchmark_tpu.graph import (
    add_self_loops as jax_add_self_loops,
    edge_partition as jax_edge_partition,
    from_coo as jax_from_coo,
    random_graph as jax_random_graph,
    remove_duplicate_edges as jax_remove_duplicate_edges,
)
from custom_op_benchmark_tpu.graph import native as jax_native
from custom_op_benchmark_tpu.graph.partition import (
    edge_block_rows as jax_edge_block_rows,
    partition_csr as jax_partition_csr,
)
from custom_op_benchmark_tpu.graph.reorder import (
    connected_components as jax_connected_components,
)
from custom_op_benchmark_tpu_torch.graph import (
    add_self_loops,
    cached,
    clique_batch,
    connected_components,
    edge_block_rows,
    edge_partition,
    ell_pack,
    from_coo,
    graph_key,
    partition_csr,
    random_graph,
    remove_duplicate_edges,
)
from custom_op_benchmark_tpu_torch.graph import cache as cache_mod
from custom_op_benchmark_tpu_torch.graph import native
from custom_op_benchmark_tpu_torch.ops import ell_dual

GRAPH_FIELDS = ("src", "dst", "indptr_r", "csc_perm", "csc_perm_inv",
                "indptr_c")


def _assert_graphs_equal(g, jg):
    assert (g.n_nodes, g.n_edges) == (jg.n_nodes, jg.n_edges)
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(g, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)


@pytest.fixture
def numpy_only(monkeypatch):
    """The numpy path: the library's loader reports nothing built."""
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()


# ---------------------------------------------------------------------------
# Builders and partitioning
# ---------------------------------------------------------------------------

def test_add_self_loops_and_dedup():
    """tests/test_graph.py's case: 0->1 twice and a loop on 2."""
    src, dst = np.array([0, 0, 2]), np.array([1, 1, 2])
    g, jg = from_coo(src, dst, 3), jax_from_coo(src, dst, 3)
    g2 = add_self_loops(g)
    s, d = g2.src.numpy()[: g2.n_edges], g2.dst.numpy()[: g2.n_edges]
    assert set(s[s == d].tolist()) == {0, 1, 2}
    assert g2.n_edges == 3 + 2
    _assert_graphs_equal(g2, jax_add_self_loops(jg))
    g3 = remove_duplicate_edges(g)
    assert g3.n_edges == 2
    _assert_graphs_equal(g3, jax_remove_duplicate_edges(jg))


@pytest.mark.parametrize("pad_multiple", [None, 64])
def test_builders_equal_jax_on_a_multigraph(pad_multiple):
    kw = dict(seed=4, power_law=True, self_loops=False)
    g = random_graph(90, 700, **kw)
    jg = jax_random_graph(90, 700, **kw)
    for fn, jfn in ((add_self_loops, jax_add_self_loops),
                    (remove_duplicate_edges, jax_remove_duplicate_edges)):
        _assert_graphs_equal(fn(g, pad_multiple=pad_multiple),
                             jfn(jg, pad_multiple=pad_multiple))


def test_partition_csr_matches_reference_contract():
    """The reference's hand example (part_csr.py:29-32) and random CSR."""
    row, ptr = partition_csr(np.array([0, 3, 10, 12]), 3)
    np.testing.assert_array_equal(row, [0, 1, 1, 1, 2])
    np.testing.assert_array_equal(ptr, [0, 3, 6, 9, 10, 12])
    rng = np.random.default_rng(2)
    deg = rng.integers(0, 50, 33)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    row, ptr = partition_csr(indptr, 8)
    jrow, jptr = jax_partition_csr(indptr, 8)
    np.testing.assert_array_equal(row, jrow)
    np.testing.assert_array_equal(ptr, jptr)
    sizes = np.diff(ptr)
    assert np.all(sizes >= 1) and np.all(sizes <= 8)


def test_edge_block_rows():
    indptr = np.array([0, 3, 3, 10, 12])
    np.testing.assert_array_equal(edge_block_rows(indptr, 4), [0, 2, 2, 3])
    rng = np.random.default_rng(5)
    indptr = np.concatenate([[0], np.cumsum(rng.integers(0, 9, 40))])
    for bs in (1, 7, 64, 1000):
        np.testing.assert_array_equal(edge_block_rows(indptr, bs),
                                      jax_edge_block_rows(indptr, bs))


@pytest.mark.parametrize("parts", [1, 3, 4])
def test_edge_partition_equals_jax(parts):
    g, jg = random_graph(50, 333, seed=3), jax_random_graph(50, 333, seed=3)
    part, jpart = edge_partition(g, parts), jax_edge_partition(jg, parts)
    eids = part.eid
    assert sorted(eids[eids < g.n_edges].tolist()) == list(range(g.n_edges))
    assert np.all(part.src[eids >= g.n_edges] == g.n_nodes)
    for f in ("num_parts", "edges_per_part", "n_nodes", "n_edges"):
        assert getattr(part, f) == getattr(jpart, f), f
    for f in ("src", "dst", "eid", "row_lo", "row_hi"):
        np.testing.assert_array_equal(getattr(part, f),
                                      np.asarray(getattr(jpart, f)))


# ---------------------------------------------------------------------------
# The native library
# ---------------------------------------------------------------------------

def test_the_library_builds_from_the_ports_own_source():
    assert native.available()
    so = native.build()
    assert so.parent == native.BUILD_DIR and so.exists()
    assert native.SOURCE.parent.name == "csrc"
    assert "custom_op_benchmark_tpu_torch" in native.SOURCE.parts


def test_build_dual_csr_matches_numpy():
    """tests/test_native.py's case, and the counter."""
    rng = np.random.default_rng(0)
    n, e = 37, 500
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    before = native.build_dual_csr.calls
    src_c, dst_c, indptr_r, csc_perm, csc_perm_inv, indptr_c = (
        native.build_dual_csr(src, dst, n))
    assert native.build_dual_csr.calls == before + 1
    order = np.lexsort((dst, src))
    np.testing.assert_array_equal(src_c, src[order])
    np.testing.assert_array_equal(dst_c, dst[order])
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src[order], minlength=n), out=indptr[1:])
    np.testing.assert_array_equal(indptr_r[: n + 1], indptr)
    assert indptr_r[n + 1] == e
    np.testing.assert_array_equal(csc_perm,
                                  np.argsort(dst_c, kind="stable"))
    np.testing.assert_array_equal(csc_perm[csc_perm_inv], np.arange(e))


@pytest.mark.parametrize("pad", [{}, {"pad_multiple": 64}, {"pad_to": 900}])
def test_from_coo_native_equals_numpy_and_jax(pad, monkeypatch):
    rng = np.random.default_rng(1)
    n = 120
    src, dst = rng.integers(0, n, 800), rng.integers(0, n, 800)
    before = native.build_dual_csr.calls
    g = from_coo(src, dst, n, **pad)
    assert native.build_dual_csr.calls == before + 1
    _assert_graphs_equal(g, jax_from_coo(src, dst, n, **pad))
    monkeypatch.setattr(native, "_load", lambda: None)
    _assert_graphs_equal(from_coo(src, dst, n, **pad),
                         jax_from_coo(src, dst, n, **pad))
    assert native.build_dual_csr.calls == before + 1


def test_partition_csr_native_matches_python():
    rng = np.random.default_rng(1)
    indptr = np.concatenate([[0], np.cumsum(rng.integers(0, 40, 25))])
    row_n, ptr_n = native.partition_csr_native(indptr.astype(np.int32), 8)
    row_p, ptr_p = partition_csr(indptr, 8)
    np.testing.assert_array_equal(row_n, row_p)
    np.testing.assert_array_equal(ptr_n, ptr_p)


def test_components_are_labelled_by_their_smallest_id(monkeypatch):
    """Both paths give the smallest id of each component, which is the JAX
    package's union-find fallback's label; the native roots (union by
    size) are the same partition with other labels."""
    rng = np.random.default_rng(0)
    n, e = 200, 150
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    roots = native.connected_components_native(src, dst, n)
    lab_native = connected_components(src, dst, n)
    monkeypatch.setattr(native, "_load", lambda: None)
    lab_numpy = connected_components(src, dst, n)
    np.testing.assert_array_equal(lab_native, lab_numpy)
    first = np.full(n, n)
    np.minimum.at(first, lab_numpy, np.arange(n))
    np.testing.assert_array_equal(first[lab_numpy], lab_numpy)
    # The native roots partition the nodes the same way.
    _, inv_r = np.unique(roots, return_inverse=True)
    _, inv_l = np.unique(lab_native, return_inverse=True)
    assert len(set(zip(inv_r.tolist(), inv_l.tolist()))) == len(set(
        inv_r.tolist()))
    # JAX's fallback labels (its Python union-find, smallest root).
    monkeypatch.setattr(jax_native, "_lib", False)
    np.testing.assert_array_equal(
        lab_numpy, jax_connected_components(src, dst, n))


@pytest.mark.parametrize("direction", ["src", "dst"])
@pytest.mark.parametrize("widths", [None, "train"])
def test_native_ell_pack_matches_numpy_and_jax(direction, widths,
                                               monkeypatch):
    from custom_op_benchmark_tpu.graph.ell import ell_pack as jax_ell_pack
    from custom_op_benchmark_tpu_torch.graph import TRAIN_WIDTHS

    kw = {} if widths is None else {"widths": TRAIN_WIDTHS}
    g = random_graph(500, 4000, seed=2, power_law=True)
    jg = jax_random_graph(500, 4000, seed=2, power_law=True)
    before = native.ell_pack_native.calls
    packs = [ell_pack(g, direction=direction, **kw)]
    assert native.ell_pack_native.calls == before + 1
    packs.append(jax_ell_pack(jg, direction=direction, **kw))
    monkeypatch.setattr(native, "_load", lambda: None)
    packs.append(ell_pack(g, direction=direction, **kw))
    nat, jx, num = packs
    for other in (jx, num):
        assert (nat.total_rows, nat.total_slots) == (other.total_rows,
                                                     other.total_slots)
        assert len(nat.buckets) == len(other.buckets)
        np.testing.assert_array_equal(nat.row_pos.numpy(),
                                      np.asarray(other.row_pos))
        np.testing.assert_array_equal(nat.edge_pos.numpy(),
                                      np.asarray(other.edge_pos))
        for a, b in zip(nat.buckets, other.buckets):
            assert (a.width, a.num_rows) == (b.width, b.num_rows)
            for f in ("rows", "cols", "eid"):
                np.testing.assert_array_equal(getattr(a, f).numpy(),
                                              np.asarray(getattr(b, f)))
        assert nat.row_pos.dtype == nat.edge_pos.dtype == torch.int32


def test_numpy_only_path_still_builds_graphs(numpy_only):
    g = random_graph(60, 300, seed=1, power_law=True)
    se, de = ell_dual(g)
    assert se.total_slots >= g.n_edges and de.total_slots >= g.n_edges


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------

def test_cached_view_roundtrip(tmp_path):
    g = clique_batch(3, 6)
    calls = []

    def build():
        calls.append(1)
        return ell_dual(g)

    v1 = cached(g, "ell_dual", build, cache_dir=str(tmp_path))
    v2 = cached(g, "ell_dual", build, cache_dir=str(tmp_path))
    assert len(calls) == 1                      # the second call loaded
    for a, b in zip(v1, v2):
        assert (a.direction, a.n_edges, a.total_slots) == (
            b.direction, b.n_edges, b.total_slots)
        for t, u in zip([a.row_pos, a.edge_pos] + a.twin_slot,
                        [b.row_pos, b.edge_pos] + b.twin_slot):
            assert torch.equal(t, u)
        for ba, bb in zip(a.buckets, b.buckets):
            assert (ba.width, ba.num_rows) == (bb.width, bb.num_rows)
            assert torch.equal(ba.cols, bb.cols) and torch.equal(ba.eid,
                                                                 bb.eid)
    assert v2[0].direction == "src" and v2[1].direction == "dst"
    assert v2[0].n_edges == g.n_edges
    # The loaded packing runs the ops: its S3 table rebuilds on demand.
    x = torch.ones(g.n_nodes, 2)
    from custom_op_benchmark_tpu_torch.ops import ell_copy_spmm
    assert torch.equal(ell_copy_spmm(v2[1], v2[0], x),
                       ell_copy_spmm(v1[1], v1[0], x))
    assert graph_key(g, "x") != graph_key(clique_batch(3, 7), "x")


def test_default_dir_is_user_owned(monkeypatch):
    monkeypatch.delenv("COB_CACHE_DIR", raising=False)
    assert cache_mod._default_dir().startswith(os.path.expanduser("~"))


def test_untrusted_dir_not_unpickled(tmp_path):
    g = from_coo([0, 1], [1, 0], 2)
    d = str(tmp_path / "c")
    calls = {"n": 0}

    def build():
        calls["n"] += 1
        return {"a": np.arange(3), "t": (torch.ones(2), 5)}

    cached(g, "v", build, cache_dir=d)
    out = cached(g, "v", build, cache_dir=d)
    assert calls["n"] == 1
    np.testing.assert_array_equal(out["a"], np.arange(3))
    assert torch.equal(out["t"][0], torch.ones(2)) and out["t"][1] == 5
    os.chmod(d, 0o777)
    cached(g, "v", build, cache_dir=d)
    assert calls["n"] == 2


def test_cache_keys_on_params_and_skips_jax_entries(tmp_path):
    g = clique_batch(2, 5)
    made = []

    def build():
        made.append(1)
        return [torch.arange(4)]

    cached(g, "v", build, cache_dir=str(tmp_path), params="a")
    cached(g, "v", build, cache_dir=str(tmp_path), params="b")
    assert len(made) == 2
    names = sorted(os.listdir(tmp_path))
    assert names and all(n.startswith("torch-v-") for n in names)
