"""The gather plan and edge-partitioned training of the port against JAX.

Counterpart of tests/test_parallel.py on a local mesh of 8 shards on the
CPU (JAX: its 8 fake CPU devices). Each op of the gather plan
(``parallel/shard_ops.py``) takes the same numpy inputs as JAX's, and its
output and gradients agree with JAX's within 1e-4 and with the port's
single-device segment ops; ``fit_edge_partitioned`` trains the
transformer on both plans; ``_pick_order`` picks the balanced order on a
power-law graph and the cluster order on disjoint cliques, with the
card's weight (``train_dist.COMM_WEIGHT``). Beyond the reference: three
Adam steps of ``fit_edge_partitioned`` (GAT and transformer, halo and
gather plans, the order given explicitly) from JAX's initial weights give
JAX's loss and accuracies within 1e-4, and the gather plan's backward
runs no accumulating scatter.
"""

import jax
import numpy as np
import pytest
import torch

from custom_op_benchmark_tpu.data import planted_partition as jax_planted
from custom_op_benchmark_tpu.graph import random_graph as jax_random_graph
from custom_op_benchmark_tpu.parallel import make_mesh as jax_make_mesh
from custom_op_benchmark_tpu.parallel import shard_ops as jops
from custom_op_benchmark_tpu.parallel import train_dist as jtrain
from custom_op_benchmark_tpu_torch import ops
from custom_op_benchmark_tpu_torch.data import planted_partition
from custom_op_benchmark_tpu_torch.graph import random_graph
from custom_op_benchmark_tpu_torch.parallel import make_mesh, shard_ops
from custom_op_benchmark_tpu_torch.parallel.train_dist import (
    COMM_WEIGHT,
    _pick_order,
    fit_edge_partitioned,
)
from tests.test_torch_determinism import (  # noqa: F401
    AtomicScan,
    one_thread,
    unsafe_nodes,
)

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def setup():
    g = random_graph(50, 400, seed=0)
    jg = jax_random_graph(50, 400, seed=0)
    mesh = make_mesh((8,), ("edge",), device="cpu")
    jmesh = jax_make_mesh(axis_names=("edge",))
    return dict(g=g, jg=jg, mesh=mesh, jmesh=jmesh,
                dg=shard_ops.dist_graph(g, mesh),
                jdg=jops.dist_graph(jg, jmesh))


def _np(x):
    return np.asarray(jax.device_get(x))


def _nodes(s, *arrays):
    return [(shard_ops.shard_nodes(s["dg"], s["mesh"], a).requires_grad_(),
             jops.shard_nodes(s["jdg"], s["jmesh"], a)) for a in arrays]


def _edges(s, a):
    """Canonical edge data → (port slot order, JAX slot order)."""
    te = shard_ops.shard_edges(s["dg"], s["mesh"], a).requires_grad_()
    je = jax.device_put(te.detach().numpy(), jax.sharding.NamedSharding(
        s["jmesh"], jax.sharding.PartitionSpec("edge")))
    return te, je


def _canon(s, y):
    """Slot-order edge values → canonical order (real edges)."""
    eid = s["dg"].eid.reshape(-1)
    out = np.zeros((s["g"].n_edges,) + y.shape[1:], np.float32)
    real = eid < s["g"].n_edges
    out[eid[real]] = y[real]
    return out


def _fwd_bwd(fn, jfn, pairs):
    ts, js = [t for t, _ in pairs], [j for _, j in pairs]
    with AtomicScan() as scan:
        y = fn(*ts)
        assert unsafe_nodes(y) == []
        grads = torch.autograd.grad((y ** 2).sum(), ts)
    assert not scan.hits, scan.hits
    jy = jax.jit(jfn)(*js)
    jgrads = jax.jit(jax.grad(lambda *a: (jfn(*a) ** 2).sum(),
                              argnums=tuple(range(len(js)))))(*js)
    np.testing.assert_allclose(y.detach().numpy(), _np(jy), **TOL)
    for a, b in zip(grads, jgrads):
        np.testing.assert_allclose(a.numpy(), _np(b), **TOL)
    return y, grads


def test_mesh_has_8_devices(setup):
    assert setup["mesh"].shape["edge"] == 8
    assert setup["dg"].num_parts == 8
    assert setup["dg"].n_pad == setup["jdg"].n_pad
    assert np.array_equal(setup["dg"].src.numpy().reshape(-1),
                          _np(setup["jdg"].src))


def test_dist_sddmm_matches_single(setup):
    s = setup
    n = s["g"].n_nodes
    rng = np.random.default_rng(0)
    pairs = _nodes(s, *(rng.normal(size=(n, 2, 8)).astype(np.float32)
                        for _ in range(2)))
    y, _ = _fwd_bwd(
        lambda a, b: shard_ops.dist_sddmm(s["dg"], s["mesh"], a, b),
        lambda a, b: jops.dist_sddmm(s["jdg"], s["jmesh"], a, b), pairs)
    want = ops.sddmm(s["g"], *[t.detach()[:n] for t, _ in pairs])
    np.testing.assert_allclose(_canon(s, y.detach().numpy()),
                               want.numpy()[: s["g"].n_edges], **TOL)


def test_dist_softmax_matches_single(setup):
    s = setup
    rng = np.random.default_rng(2)
    x = rng.normal(size=(s["g"].n_edges, 2)).astype(np.float32)
    for by in ("src", "dst"):
        te, je = _edges(s, x)
        y, _ = _fwd_bwd(
            lambda e: shard_ops.dist_edge_softmax(s["dg"], s["mesh"], e,
                                                  by=by),
            lambda e: jops.dist_edge_softmax(s["jdg"], s["jmesh"], e,
                                             by=by), [(te, je)])
        want = ops.edge_softmax(s["g"], torch.from_numpy(x), by=by)
        np.testing.assert_allclose(_canon(s, y.detach().numpy()),
                                   want.numpy(), **TOL)


def test_dist_spmm_matches_single(setup):
    s = setup
    n = s["g"].n_nodes
    rng = np.random.default_rng(3)
    ed = rng.normal(size=(s["g"].n_edges, 2)).astype(np.float32)
    x = rng.normal(size=(n, 2, 8)).astype(np.float32)
    for to in ("src", "dst"):
        pair_e = _edges(s, ed)
        pair_x, = _nodes(s, x)
        y, _ = _fwd_bwd(
            lambda e, x: shard_ops.dist_vector_spmm(s["dg"], s["mesh"], e, x,
                                                    to=to),
            lambda e, x: jops.dist_vector_spmm(s["jdg"], s["jmesh"], e, x,
                                               to=to), [pair_e, pair_x])
        if to == "src":
            want = ops.vector_spmm(s["g"], torch.from_numpy(ed),
                                   torch.from_numpy(x))
            np.testing.assert_allclose(y.detach().numpy()[:n], want.numpy(),
                                       **TOL)


def test_dist_attention_matches_single_and_differentiates(setup):
    s = setup
    g, n = s["g"], s["g"].n_nodes
    rng = np.random.default_rng(4)
    qkv = [rng.normal(size=(n, 2, 8)).astype(np.float32) for _ in range(3)]
    y, _ = _fwd_bwd(
        lambda q, k, v: shard_ops.dist_gat_attention(s["dg"], s["mesh"], q, k,
                                                     v),
        lambda q, k, v: jops.dist_gat_attention(s["jdg"], s["jmesh"], q, k,
                                                v), _nodes(s, *qkv))
    q, k, v = (torch.from_numpy(a) for a in qkv)
    scores = ops.sddmm(g, k, q) / np.sqrt(8.0)
    alpha = ops.edge_softmax(g, scores, by="dst")
    want = ops.vector_spmm(g.reverse(), alpha[g.csc_perm.long()], v)
    np.testing.assert_allclose(y.detach().numpy()[:n], want.numpy(), **TOL)


def test_fit_edge_partitioned_transformer():
    """The distributed transformer trains to separation on both plans."""
    ds = planted_partition(num_classes=3, nodes_per_class=80, feat_dim=16,
                           avg_degree=8, seed=2)
    mesh = make_mesh((4,), ("edge",), device="cpu")
    _, m_halo = fit_edge_partitioned(
        ds, mesh, hidden=32, num_heads=2, num_layers=2, epochs=60,
        learning_rate=2e-3, plan="halo", arch="transformer")
    assert m_halo["val_acc"] > 0.85, m_halo
    _, m_gather = fit_edge_partitioned(
        ds, mesh, hidden=32, num_heads=2, num_layers=2, epochs=30,
        learning_rate=2e-3, plan="gather", arch="transformer")
    assert np.isfinite(m_gather["loss"]), m_gather


def test_pick_order_by_graph_structure():
    """The balanced order on a locality-free power-law graph, the cluster
    order on disjoint cliques; each pick the candidate of least cost."""
    from custom_op_benchmark_tpu_torch.graph import (
        clique_batch,
        degree_balanced_order,
    )
    from custom_op_benchmark_tpu_torch.graph.cluster import cluster_order

    assert COMM_WEIGHT > 1     # a link row costs more than a gathered row
    g_pl = random_graph(2048, 40_000, seed=0, power_law=True)
    details = {}
    assert np.array_equal(_pick_order(g_pl, 4, details).perm,
                          degree_balanced_order(g_pl, 4).perm)
    assert details["picked"] == "balanced"
    assert details["balanced"]["cost"] < details["cluster"]["cost"]
    g_cl = clique_batch(64, 16)
    assert np.array_equal(_pick_order(g_cl, 4).perm,
                          cluster_order(g_cl, 4).perm)


@pytest.mark.parametrize("arch", ["gat", "transformer"])
@pytest.mark.parametrize("plan", ["halo", "gather"])
def test_three_adam_steps_match_jax(arch, plan):
    """Three Adam steps from JAX's initial weights: the last step's loss
    and the final accuracies equal JAX's within 1e-4."""
    kw = dict(num_classes=3, nodes_per_class=40, feat_dim=16, avg_degree=6,
              seed=2)
    ds, jds = planted_partition(**kw), jax_planted(**kw)
    init = (jtrain.init_dist_gat if arch == "gat"
            else jtrain.init_dist_transformer)(jax.random.PRNGKey(0), 16, 16,
                                               3, 2, 2)
    init = jax.tree_util.tree_map(np.asarray, init)
    fit = dict(hidden=16, num_heads=2, num_layers=2, epochs=3,
               learning_rate=1e-2, plan=plan, arch=arch, order="cluster")
    _, jm = jtrain.fit_edge_partitioned(jds, jax_make_mesh((4,), ("edge",)),
                                        **fit)
    _, m = fit_edge_partitioned(ds, make_mesh((4,), ("edge",),
                                              device="cpu"),
                                init_params=init, **fit)
    for key in ("loss", "train_acc", "val_acc"):
        np.testing.assert_allclose(m[key], jm[key], rtol=1e-4, atol=1e-4,
                                   err_msg=key)
    assert m["num_devices"] == jm["num_devices"] == 4
    if plan == "halo":
        assert m["plan"]["order"] == "cluster"
        assert m["plan"]["route"] == "numpy"      # the "auto" hub sweep


def test_collectives_and_their_transposes():
    """The local mesh's collectives: all_to_all swaps the shard and block
    axes, all_gather gives every shard every block, psum and psum_scatter
    sum in shard order, pmax takes the maximum; each backward is the
    transposed collective (all_to_all ↔ all_to_all, all_gather ↔
    psum_scatter, psum ↔ psum)."""
    from custom_op_benchmark_tpu_torch.parallel import mesh as M

    mesh = make_mesh((4,), ("edge",), device="cpu")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 4, 3, generator=gen, requires_grad=True)
    y = torch.randn(4, 4, 3, generator=gen)
    a2a = M.all_to_all(mesh, "edge", x)
    assert torch.equal(a2a, x.detach().transpose(0, 1))
    (gx,) = torch.autograd.grad((a2a * y).sum(), (x,))
    assert torch.equal(gx, M.all_to_all(mesh, "edge", y))
    ps = M.psum_scatter(mesh, "edge", x)
    want = x.detach()[0].clone()
    for i in range(1, 4):
        want = want + x.detach()[i]
    assert torch.equal(ps, want)
    z = torch.randn(4, 3, generator=gen)
    (gx,) = torch.autograd.grad((ps * z).sum(), (x,))
    assert torch.equal(gx, M.all_gather(mesh, "edge", z))
    b = torch.randn(4, 3, generator=gen, requires_grad=True)
    ag = M.all_gather(mesh, "edge", b)
    assert all(torch.equal(ag[r], b.detach()) for r in range(4))
    (gb,) = torch.autograd.grad((ag * y).sum(), (b,))
    assert torch.equal(gb, M.psum_scatter(mesh, "edge", y))
    s = M.psum(mesh, "edge", b)
    assert all(torch.equal(s[r], b.detach().sum(0)) for r in range(4))
    (gb,) = torch.autograd.grad((s * z).sum(), (b,))
    assert torch.equal(gb, M.psum(mesh, "edge", z))
    assert torch.equal(M.pmax(mesh, "edge", b)[2], b.detach().amax(0))
