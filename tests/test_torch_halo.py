"""The halo plan of the port (``parallel/halo.py``) against the JAX package's.

Every case of tests/test_halo.py on the same graphs (``random_graph(96,
800, power_law)`` and ``clique_batch(8, 11)``, P = 4): the same numpy
inputs go through the JAX op on its 8-device CPU mesh and through the
port's op on a local mesh of 4 shards on the CPU, and the outputs and
gradients agree within 1e-4 (f32 sums of the same terms in other orders;
the port sums segments on S3's CSR entry). Where the reference checks a
structure (the overlap sections, the halo fraction, the hub split), the
port's plan is checked the same way. Beyond the reference:

- every plan array equals JAX's bit for bit, on the native planner and on
  the numpy one, with and without hubs (``hub_threshold`` None, 2 and
  ``"auto"``), and every ``HaloEll`` array too;
- the exchange's landing and every op's backward run no accumulating
  scatter (``AtomicScan``, ``unsafe_nodes``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_op_benchmark_tpu.graph import clique_batch as jax_clique_batch
from custom_op_benchmark_tpu.graph import random_graph as jax_random_graph
from custom_op_benchmark_tpu.graph import native as jax_native
from custom_op_benchmark_tpu.parallel import halo as jhalo
from custom_op_benchmark_tpu.parallel import make_mesh as jax_make_mesh
from custom_op_benchmark_tpu_torch.graph import clique_batch, random_graph
from custom_op_benchmark_tpu_torch.graph import native
from custom_op_benchmark_tpu_torch.parallel import halo, make_mesh
from tests.test_torch_determinism import (  # noqa: F401
    AtomicScan,
    one_thread,
    unsafe_nodes,
)

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = dict(rtol=1e-4, atol=1e-4)
P = 4
PLAN_FIELDS = ("send_idx", "src_ext", "dst_loc", "eid", "hub_idx",
               "hub_pos")
ELL_LISTS = ("rows_b", "cols_b", "epos_b", "rows_t_b", "cols_t_b",
             "epos_t_b", "twin_pos_t")
ELL_ARRAYS = ("row_pos", "row_pos_t", "halo_pos_t", "recv_pos", "slot_pos")
ELL_STATIC = ("widths", "n_bnd", "n_halo_t", "total_rows", "total_rows_t",
              "halo_rows_t")


def _graphs(kind):
    if kind == "power_law":
        return (random_graph(96, 800, seed=2, power_law=True),
                jax_random_graph(96, 800, seed=2, power_law=True))
    return clique_batch(8, 11), jax_clique_batch(8, 11)


@pytest.fixture(scope="module", params=["power_law", "clique"])
def setup(request):
    g, jg = _graphs(request.param)
    mesh = make_mesh((P,), ("edge",), device="cpu")
    jmesh = jax_make_mesh((P,), ("edge",))
    hg, jhg = halo.halo_graph(g, mesh), jhalo.halo_graph(jg, jmesh)
    he, jhe = halo.halo_ell(hg, mesh), jhalo.halo_ell(jhg, jmesh)
    return dict(g=g, jg=jg, mesh=mesh, jmesh=jmesh, hg=hg, jhg=jhg, he=he,
                jhe=jhe, rng=np.random.default_rng(0))


def _np(x):
    return np.asarray(jax.device_get(x))


def _pair(s, *arrays):
    """Each numpy array as (port tensor, JAX array), node-sharded."""
    return [(halo.shard_halo_nodes(s["hg"], s["mesh"], a).requires_grad_(),
             jhalo.shard_halo_nodes(s["jhg"], s["jmesh"], a))
            for a in arrays]


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), _np(want),
                               **(tol or TOL))


def _check_fwd_bwd(port_fn, jax_fn, pairs, n_real=None):
    """Forward and the gradient of Σ y² through both packages, each result
    within TOL; the port's backward under AtomicScan."""
    ts = [t for t, _ in pairs]
    js = [j for _, j in pairs]
    with AtomicScan() as scan:
        y = port_fn(*ts)
        assert unsafe_nodes(y) == []
        grads = torch.autograd.grad((y.float() ** 2).sum(), ts)
    assert not scan.hits, scan.hits
    jy = jax.jit(jax_fn)(*js)
    jgrads = jax.jit(jax.grad(lambda *a: (jax_fn(*a).astype(jnp.float32)
                                          ** 2).sum(),
                              argnums=tuple(range(len(js)))))(*js)
    sl = slice(None, n_real)
    np.testing.assert_allclose(y.detach().numpy()[sl], _np(jy)[sl], **TOL)
    for a, b in zip(grads, jgrads):
        np.testing.assert_allclose(a.numpy()[sl], _np(b)[sl], **TOL)
    return y, grads


@pytest.mark.parametrize("kind", ["power_law", "clique"])
@pytest.mark.parametrize("hub", [None, 2, "auto"])
@pytest.mark.parametrize("route", ["native", "numpy"])
def test_plan_arrays_equal_jax(kind, hub, route, monkeypatch):
    """Every plan and packing array equals JAX's bit for bit, and the
    route that built it is the one asked for (a hub plan is numpy's in
    both packages)."""
    if route == "numpy":
        monkeypatch.setattr(native, "_load", lambda: None)
        monkeypatch.setattr(jax_native, "halo_plan_native",
                            lambda *a, **k: None)
        monkeypatch.setattr(jax_native, "halo_pack_native",
                            lambda *a, **k: None)
    elif not native.available():
        pytest.skip("the graphcore library does not build here")
    g, jg = _graphs(kind)
    mesh = make_mesh((P,), ("edge",), device="cpu")
    jmesh = jax_make_mesh((P,), ("edge",))
    hg = halo.halo_graph(g, mesh, hub_threshold=hub)
    jhg = jhalo.halo_graph(jg, jmesh, hub_threshold=hub)
    assert hg.route == ("native" if route == "native" and hub is None
                        else "numpy")
    for f in PLAN_FIELDS:
        a, b = getattr(hg, f).numpy(), _np(getattr(jhg, f))
        assert a.shape == b.shape and (a == b).all(), f
    for f in ("n_per", "halo", "n_hub", "edges_per_part"):
        assert getattr(hg, f) == getattr(jhg, f), f
    he, jhe = halo.halo_ell(hg, mesh), jhalo.halo_ell(jhg, jmesh)
    assert he.route == route
    for f in ELL_LISTS:
        a, b = getattr(he, f), getattr(jhe, f)
        assert len(a) == len(b), f
        for x, y in zip(a, b):
            assert x.shape == tuple(y.shape) and (x.numpy() == _np(y)).all(), f
    for f in ELL_ARRAYS:
        a, b = getattr(he, f).numpy(), _np(getattr(jhe, f))
        assert a.shape == b.shape and (a == b).all(), f
    for f in ELL_STATIC:
        assert getattr(he, f) == getattr(jhe, f), f


def test_halo_spmm_matches_oracle(setup):
    s = setup
    x = s["rng"].normal(size=(s["g"].n_nodes, 8)).astype(np.float32)
    ed = s["rng"].uniform(size=s["g"].num_edges_padded).astype(np.float32)
    (tx, jx), = _pair(s, x)
    te = halo.halo_edge_data(s["hg"], s["mesh"], ed).requires_grad_()
    je = jhalo.halo_edge_data(s["jhg"], s["jmesh"], ed)
    assert np.array_equal(te.detach().numpy(), _np(je))
    _check_fwd_bwd(lambda e, x: halo.halo_spmm(s["hg"], s["mesh"], e, x),
                   lambda e, x: jhalo.halo_spmm(s["jhg"], s["jmesh"], e, x),
                   [(te, je), (tx, jx)])


def test_halo_attention_matches_oracle(setup):
    s = setup
    n = s["g"].n_nodes
    pairs = _pair(s, *(s["rng"].normal(size=(n, 2, 8)).astype(np.float32)
                       for _ in range(3)))
    y = halo.halo_gat_attention(s["hg"], s["mesh"], *[t for t, _ in pairs])
    jy = jax.jit(lambda q, k, v: jhalo.halo_gat_attention(
        s["jhg"], s["jmesh"], q, k, v))(*[j for _, j in pairs])
    _close(y, jy)


def test_halo_attention_grads(setup):
    s = setup
    n = s["g"].n_nodes
    pairs = _pair(s, *(s["rng"].normal(size=(n, 2, 4)).astype(np.float32)
                       for _ in range(3)))
    _check_fwd_bwd(
        lambda q, k, v: halo.halo_gat_attention(s["hg"], s["mesh"], q, k, v),
        lambda q, k, v: jhalo.halo_gat_attention(s["jhg"], s["jmesh"], q, k,
                                                 v), pairs)


def test_halo_fraction_reasonable(setup):
    s = setup
    hg, g = s["hg"], s["g"]
    assert hg.halo_fraction == s["jhg"].halo_fraction >= 0
    eids = hg.eid.numpy().reshape(-1)
    real = eids[eids < g.num_edges_padded]
    assert len(real) == g.n_edges and len(np.unique(real)) == g.n_edges


def test_cluster_order_reduces_halo():
    """The cluster order equals JAX's, cuts the halo, and the ops still
    agree with JAX's on the reordered graph."""
    from custom_op_benchmark_tpu.data import planted_partition as jpp
    from custom_op_benchmark_tpu.graph import cluster_order as jco
    from custom_op_benchmark_tpu.graph import reorder_graph as jrg
    from custom_op_benchmark_tpu_torch.data import planted_partition
    from custom_op_benchmark_tpu_torch.graph import reorder_graph
    from custom_op_benchmark_tpu_torch.graph.cluster import cluster_order

    kw = dict(num_classes=8, nodes_per_class=32, seed=0, homophily=0.95,
              avg_degree=8)
    g, jg = planted_partition(**kw).graph, jpp(**kw).graph
    mesh = make_mesh((P,), ("edge",), device="cpu")
    jmesh = jax_make_mesh((P,), ("edge",))
    ro, jro = cluster_order(g, P), jco(jg, P)
    assert ro.n_new == jro.n_new and np.array_equal(ro.perm, jro.perm)
    g2, _ = reorder_graph(g, ro)
    jg2, _ = jrg(jg, jro)
    hg0, hg1 = halo.halo_graph(g, mesh), halo.halo_graph(g2, mesh)
    assert hg1.halo_fraction < hg0.halo_fraction * 0.8
    jhg1 = jhalo.halo_graph(jg2, jmesh)
    rng = np.random.default_rng(0)
    x = ro.scatter_nodes(torch.from_numpy(rng.normal(
        size=(g.n_nodes, 4)).astype(np.float32))).numpy()
    ed = rng.uniform(size=g2.num_edges_padded).astype(np.float32)
    y = halo.halo_spmm(hg1, mesh, halo.halo_edge_data(hg1, mesh, ed),
                       halo.shard_halo_nodes(hg1, mesh, x))
    jy = jhalo.halo_spmm(jhg1, jmesh, jhalo.halo_edge_data(jhg1, jmesh, ed),
                         jhalo.shard_halo_nodes(jhg1, jmesh, x))
    _close(y, jy)


@pytest.mark.parametrize("multihead", [False, True])
def test_halo_attention_ell_matches(setup, multihead):
    s = setup
    n = s["g"].n_nodes
    shape = (n, 2, 8) if multihead else (n, 8)
    pairs = _pair(s, *(s["rng"].normal(size=shape).astype(np.float32)
                       for _ in range(3)))
    y, _ = _check_fwd_bwd(
        lambda q, k, v: halo.halo_attention_ell(s["hg"], s["he"], s["mesh"],
                                                q, k, v),
        lambda q, k, v: jhalo.halo_attention_ell(s["jhg"], s["jhe"],
                                                 s["jmesh"], q, k, v),
        pairs)
    # The ELL form equals the port's segment form.
    seg = halo.halo_gat_attention(
        s["hg"], s["mesh"], *[(t if multihead else t[:, None]).detach()
                              for t, _ in pairs])
    np.testing.assert_allclose(
        y.detach().numpy(), (seg if multihead else seg[:, 0]).numpy(), **TOL)


def test_halo_ell_overlap_sections(setup):
    """Interior rows read only local columns; halo rows of the transpose
    packing sit in their bucket's head and map back through
    ``halo_pos_t``."""
    s = setup
    hg, he = s["hg"], s["he"]
    p, n_per = hg.num_parts, hg.n_per
    for cols, n_bnd in zip(he.cols_b, he.n_bnd):
        c = cols.numpy()
        assert (c[:, : c.shape[1] - n_bnd] <= n_per).all()
    n_ext = n_per + 1 + p * hg.halo
    base = 0
    halo_pos = he.halo_pos_t.numpy()
    for rows_t, n_halo in zip(he.rows_t_b, he.n_halo_t):
        rt = rows_t.numpy()
        tail = rt[:, n_halo:]
        assert not ((tail >= n_per + 1) & (tail < n_ext)).any()
        head = rt[:, :n_halo]
        ss, jj = np.nonzero((head >= n_per + 1) & (head < n_ext))
        assert (halo_pos[ss, head[ss, jj] - (n_per + 1)] == base + jj).all()
        base += n_halo
    assert (halo_pos <= he.halo_rows_t).all()


def test_halo_ell_interior_fraction_with_clustering():
    from custom_op_benchmark_tpu_torch.data import planted_partition
    from custom_op_benchmark_tpu_torch.graph import reorder_graph
    from custom_op_benchmark_tpu_torch.graph.cluster import cluster_order

    ds = planted_partition(num_classes=8, nodes_per_class=64, seed=1,
                           homophily=0.95, avg_degree=8)
    g, _ = reorder_graph(ds.graph, cluster_order(ds.graph, P))
    mesh = make_mesh((P,), ("edge",), device="cpu")
    he = halo.halo_ell(halo.halo_graph(g, mesh), mesh)
    total = sum(r.shape[1] for r in he.rows_b)
    assert sum(he.n_bnd) < 0.5 * total


def test_halo_attention_ell_single_head(setup):
    s = setup
    n = s["g"].n_nodes
    pairs = _pair(s, *(s["rng"].normal(size=(n, 8)).astype(np.float32)
                       for _ in range(3)))
    y = halo.halo_attention_ell(s["hg"], s["he"], s["mesh"],
                                *[t for t, _ in pairs])
    jy = jax.jit(lambda q, k, v: jhalo.halo_attention_ell(
        s["jhg"], s["jhe"], s["jmesh"], q, k, v))(*[j for _, j in pairs])
    _close(y, jy)


def _edge_pair(s, ed):
    te = halo.halo_edge_data(s["hg"], s["mesh"], ed).requires_grad_()
    return te, jhalo.halo_edge_data(s["jhg"], s["jmesh"], ed)


def test_halo_spmm_ell_matches(setup):
    s = setup
    x = s["rng"].normal(size=(s["g"].n_nodes, 8)).astype(np.float32)
    ed = s["rng"].uniform(size=s["g"].num_edges_padded).astype(np.float32)
    (tx, jx), = _pair(s, x)
    te, je = _edge_pair(s, ed)
    y = halo.halo_spmm_ell(s["hg"], s["he"], s["mesh"], te, tx)
    _close(y, jax.jit(lambda e, x: jhalo.halo_spmm_ell(
        s["jhg"], s["jhe"], s["jmesh"], e, x))(je, jx))
    (gx,) = torch.autograd.grad((y ** 2).sum(), (tx,))
    jgx = jax.jit(jax.grad(lambda x: (jhalo.halo_spmm_ell(
        s["jhg"], s["jhe"], s["jmesh"], je, x) ** 2).sum()))(jx)
    _close(gx, jgx)


def test_halo_spmm_ell_dedata_grad(setup):
    s = setup
    x = s["rng"].normal(size=(s["g"].n_nodes, 8)).astype(np.float32)
    ed = s["rng"].uniform(size=s["g"].num_edges_padded).astype(np.float32)
    (tx, jx), = _pair(s, x)
    te, je = _edge_pair(s, ed)
    with AtomicScan() as scan:
        (ge,) = torch.autograd.grad((halo.halo_spmm_ell(
            s["hg"], s["he"], s["mesh"], te, tx) ** 2).sum(), (te,))
    assert not scan.hits
    jge = jax.jit(jax.grad(lambda e: (jhalo.halo_spmm_ell(
        s["jhg"], s["jhe"], s["jmesh"], e, jx) ** 2).sum()))(je)
    mask = s["hg"].eid.numpy().reshape(-1) < s["g"].num_edges_padded
    np.testing.assert_allclose(ge.numpy()[mask], _np(jge)[mask], **TOL)


def test_halo_packed_weights_spmm(setup):
    """Dual-packed weights: the forward and dx of the slot-order form, and
    both packed cotangent copies equal to JAX's."""
    s = setup
    x = s["rng"].normal(size=(s["g"].n_nodes, 8)).astype(np.float32)
    ed = s["rng"].uniform(size=s["g"].num_edges_padded).astype(np.float32)
    (tx, jx), = _pair(s, x)
    w = halo.halo_pack_weights(s["hg"], s["he"], s["mesh"], ed)
    jw = jhalo.halo_pack_weights(s["jhg"], s["jhe"], s["jmesh"], ed)
    for a, b in zip(w.local + w.t, jw.local + jw.t):
        assert np.array_equal(a.numpy(), _np(b))
    ws = [t.requires_grad_() for t in w.local + w.t]
    y = halo.halo_spmm_ell(s["hg"], s["he"], s["mesh"], w, tx)
    y_sl = halo.halo_spmm_ell(s["hg"], s["he"], s["mesh"],
                              halo.halo_edge_data(s["hg"], s["mesh"], ed),
                              tx)
    np.testing.assert_allclose(y.detach().numpy(), y_sl.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad((y ** 2).sum(), [tx] + ws)
    jgx, jgw = jax.jit(jax.grad(lambda x, w: (jhalo.halo_spmm_ell(
        s["jhg"], s["jhe"], s["jmesh"], w, x) ** 2).sum(),
        argnums=(0, 1)))(jx, jw)
    _close(grads[0], jgx)
    for a, b in zip(grads[1:], jgw.local + jgw.t):
        _close(a, b)


def test_halo_hub_replication(setup):
    """A hub plan (``hub_threshold=2``): equal to the plain plan's results
    for halo_spmm and the ELL attention, forward and gradients (the hub
    gradient returns through psum_scatter), and equal to JAX's."""
    s = setup
    g, mesh, hg = s["g"], s["mesh"], s["hg"]
    hgh = halo.halo_graph(g, mesh, hub_threshold=2)
    jhgh = jhalo.halo_graph(s["jg"], s["jmesh"], hub_threshold=2)
    n = g.n_nodes
    assert hgh.halo <= hg.halo
    if hgh.n_hub:
        assert (hgh.send_idx < hgh.n_per).sum() < (hg.send_idx
                                                   < hg.n_per).sum()
    heh = halo.halo_ell(hgh, mesh)
    jheh = jhalo.halo_ell(jhgh, s["jmesh"])
    q = s["rng"].normal(size=(n, 2, 8)).astype(np.float32)
    tq = halo.shard_halo_nodes(hgh, mesh, q).requires_grad_()
    jq = jhalo.shard_halo_nodes(jhgh, s["jmesh"], q)
    _check_fwd_bwd(
        lambda q: halo.halo_attention_ell(hgh, heh, mesh, q, q, q),
        lambda q: jhalo.halo_attention_ell(jhgh, jheh, s["jmesh"], q, q, q),
        [(tq, jq)])
    q0 = halo.shard_halo_nodes(hg, mesh, q).requires_grad_()
    ya = halo.halo_attention_ell(hg, s["he"], mesh, q0, q0, q0)
    yb = halo.halo_attention_ell(hgh, heh, mesh, tq, tq, tq)
    np.testing.assert_allclose(yb.detach().numpy()[:n],
                               ya.detach().numpy()[:n], **TOL)
    x = s["rng"].normal(size=(n, 8)).astype(np.float32)
    ed = s["rng"].uniform(size=g.num_edges_padded).astype(np.float32)
    y0 = halo.halo_spmm(hg, mesh, halo.halo_edge_data(hg, mesh, ed),
                        halo.shard_halo_nodes(hg, mesh, x))
    y1 = halo.halo_spmm(hgh, mesh, halo.halo_edge_data(hgh, mesh, ed),
                        halo.shard_halo_nodes(hgh, mesh, x))
    np.testing.assert_allclose(y1.numpy()[:n], y0.numpy()[:n], **TOL)


def test_halo_attention_2d_edge_head_mesh():
    """The 2-D edge × head mesh: equal to the 1-D edge mesh bit for bit
    (the local mesh keeps the head axis as a view) and to JAX's 2-D mesh
    within 1e-4, forward and gradients."""
    from jax.sharding import NamedSharding, PartitionSpec

    rng = np.random.default_rng(3)
    g = random_graph(120, 900, seed=4, power_law=True)
    jg = jax_random_graph(120, 900, seed=4, power_law=True)
    mesh2 = make_mesh((4, 2), ("edge", "head"), device="cpu")
    mesh1 = make_mesh((4,), ("edge",), device="cpu")
    jmesh2 = jax_make_mesh((4, 2), ("edge", "head"))
    hg2, hg1 = halo.halo_graph(g, mesh2), halo.halo_graph(g, mesh1)
    he2, he1 = halo.halo_ell(hg2, mesh2), halo.halo_ell(hg1, mesh1)
    jhg = jhalo.halo_graph(jg, jmesh2)
    jhe = jhalo.halo_ell(jhg, jmesh2)
    n = g.n_nodes
    arrs = [rng.normal(size=(n, 4, 8)).astype(np.float32) for _ in range(3)]
    t2 = [halo.shard_halo_nodes(hg2, mesh2, a, ("edge", "head"))
          .requires_grad_() for a in arrs]
    t1 = [halo.shard_halo_nodes(hg1, mesh1, a).requires_grad_()
          for a in arrs]

    def put2(a):
        a = np.pad(a, [(0, jhg.n_pad - n), (0, 0), (0, 0)])
        return jax.device_put(a, NamedSharding(
            jmesh2, PartitionSpec("edge", "head", None)))

    y2 = halo.halo_attention_ell(hg2, he2, mesh2, *t2, head_axis="head")
    y1 = halo.halo_attention_ell(hg1, he1, mesh1, *t1)
    assert torch.equal(y2, y1)
    g2 = torch.autograd.grad((y2 ** 2).sum(), t2)
    g1 = torch.autograd.grad((y1 ** 2).sum(), t1)
    assert all(torch.equal(a, b) for a, b in zip(g2, g1))
    _check_fwd_bwd(
        lambda q, k, v: halo.halo_attention_ell(hg2, he2, mesh2, q, k, v,
                                                head_axis="head"),
        lambda q, k, v: jhalo.halo_attention_ell(jhg, jhe, jmesh2, q, k, v,
                                                 head_axis="head"),
        list(zip(t2, [put2(a) for a in arrs])), n_real=n)
    with pytest.raises(ValueError):
        halo.halo_attention_ell(hg2, he2, mesh2, *[t[:, :3] for t in t2],
                                head_axis="head")


def test_exchange_landing_repeats_bit_for_bit(setup):
    """The segment form's exchange is an autograd op whose backward lands
    through ``recv_pos`` in shard order: two runs give equal bits."""
    s = setup
    n = s["g"].n_nodes
    x = s["rng"].normal(size=(n, 2, 4)).astype(np.float32)

    def run():
        q = halo.shard_halo_nodes(s["hg"], s["mesh"], x).requires_grad_()
        y = halo.halo_gat_attention(s["hg"], s["mesh"], q, q, q)
        return [y.detach()] + list(torch.autograd.grad((y ** 2).sum(), (q,)))

    a, b = run(), run()
    assert all(torch.equal(u, v) for u, v in zip(a, b))
