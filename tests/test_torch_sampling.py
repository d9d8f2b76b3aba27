"""Neighbour sampling, the prefetch pipeline and sampled training against
the JAX package (tests/test_sampling.py; ``fit_sampled_dp`` on a local
mesh of 4 shards on the CPU, also repeated bit for bit).

Beyond the reference's cases:
- a batch of the port's ``NeighborSampler`` equals JAX's field by field
  for the same seed: with the native whole-batch sampler on both sides,
  with the per-hop native sampler on both, and with numpy alone on both
  (the native and numpy draws differ, so the paths are compared like with
  like);
- ``sampled_copy_spmm`` forward and gradient against JAX's within 1e-5
  (the port sums with S3's Kahan sum in slot order on the card, JAX sums
  plainly: both are f32 sums of the same rows in other orders);
- one GraphSAGE step on a sampled batch from JAX's weights
  (``flax_to_state_dict``): the loss within 1e-5 relative of JAX's and
  each gradient within 1e-4 of that tensor's largest JAX value, with no
  atomic backward in the step (``tests/test_torch_determinism.py``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from custom_op_benchmark_tpu.data import (
    NeighborSampler as JaxSampler,
    planted_partition as jax_planted_partition,
)
from custom_op_benchmark_tpu.graph import native as jax_native
from custom_op_benchmark_tpu.models import GraphSAGE as JaxSAGE
from custom_op_benchmark_tpu.ops.sampled import (
    sampled_copy_spmm as jax_sampled_copy_spmm,
)
from custom_op_benchmark_tpu.train.loop import (
    masked_cross_entropy as jax_masked_ce,
)
from custom_op_benchmark_tpu_torch.data import (
    NeighborSampler,
    planted_partition,
    prefetch,
)
from custom_op_benchmark_tpu_torch.graph import native
from custom_op_benchmark_tpu_torch.models import GraphSAGE, flax_to_state_dict
from custom_op_benchmark_tpu_torch.ops import gspmm
from custom_op_benchmark_tpu_torch.ops.sampled import sampled_copy_spmm
from custom_op_benchmark_tpu_torch.train import (
    create_train_state,
    fit_sampled,
    make_sampled_step,
)
from tests.test_torch_determinism import (  # noqa: F401
    AtomicScan,
    one_thread,
    unsafe_nodes,
)

TOL = dict(rtol=1e-5, atol=1e-5)
DS = dict(num_classes=3, nodes_per_class=60, feat_dim=8, avg_degree=6,
          seed=1)


@pytest.fixture(scope="module")
def ds():
    return planted_partition(**DS)


@pytest.fixture(scope="module")
def jds():
    return jax_planted_partition(**DS)


def _edges(g):
    ne = g.n_edges
    return g.src.numpy()[:ne], g.dst.numpy()[:ne]


def test_sampler_static_shapes(ds):
    sampler = NeighborSampler(ds.graph, [5, 3], seed=0)
    b1 = sampler.sample(np.arange(8))
    b2 = sampler.sample(np.arange(8) + 8)
    assert b1.graph.num_edges_padded == b2.graph.num_edges_padded
    assert b1.graph.n_nodes == b2.graph.n_nodes
    assert b1.node_ids.shape == b2.node_ids.shape


def test_sampler_edges_are_real_in_edges(ds):
    g = ds.graph
    seeds = np.array([0, 5, 9])
    b = NeighborSampler(g, [4], seed=0).sample(seeds, add_self_loops=False)
    real = set(zip(*(a.tolist() for a in _edges(g))))
    ids = b.node_ids
    for s, d in zip(*_edges(b.graph)):
        assert (int(ids[s]), int(ids[d])) in real
        assert int(ids[d]) in set(seeds.tolist())


def test_sampler_respects_fanout(ds):
    b = NeighborSampler(ds.graph, [2], seed=0).sample(np.arange(16),
                                                     add_self_loops=False)
    _, counts = np.unique(_edges(b.graph)[1], return_counts=True)
    assert counts.max() <= 2


def test_prefetch_preserves_order():
    items = list(range(20))
    assert list(prefetch(iter(items), size=3)) == items


def test_prefetch_propagates_errors():
    def gen():
        yield 1
        raise RuntimeError("boom")

    it = prefetch(gen(), size=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        list(it)


def test_prefetch_stops_its_producer_when_the_consumer_stops():
    """Closing the consumer early ends the producer thread, which has
    drawn at most the queue's depth and one item in flight beyond what
    was consumed."""
    import threading

    pulled = []

    def endless():
        while True:
            pulled.append(len(pulled))
            yield pulled[-1]

    before = threading.active_count()
    it = prefetch(endless(), size=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    assert threading.active_count() == before
    assert len(pulled) <= 3 + 2 + 1


def test_prefetch_moves_batches_to_the_device(ds):
    """A batch through the pipeline arrives equal, tensors made of its numpy
    arrays, the graph's tensors with it."""
    b = NeighborSampler(ds.graph, [5, 3], seed=0).sample(np.arange(8))
    (g, ids, cols), = list(prefetch(iter([(b.graph, b.node_ids,
                                           b.in_cols)]), device="cpu"))
    assert torch.equal(g.src, b.graph.src) and g.n_nodes == b.graph.n_nodes
    assert torch.equal(ids, torch.from_numpy(b.node_ids))
    assert torch.equal(cols, torch.from_numpy(b.in_cols))


def test_fit_sampled_decreases_loss(ds):
    model = GraphSAGE(hidden_dim=16, out_dim=ds.num_classes, in_dim=8)
    _, metrics = fit_sampled(model, ds, fanouts=(4, 3), batch_size=32,
                             epochs=3, learning_rate=1e-2, device="cpu")
    losses = metrics["losses"]
    assert len(losses) > 3
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert np.isfinite(metrics["val_acc"])


def test_in_cols_matches_graph(ds):
    """The one-bucket in-neighbour matrix holds exactly the batch graph's
    edges (the same multiset per dst)."""
    from collections import Counter

    b = NeighborSampler(ds.graph, [5, 3], seed=0).sample(np.arange(16))
    n = b.graph.n_nodes
    src, dst = _edges(b.graph)
    want = Counter(zip(dst.tolist(), src.tolist()))
    got = Counter((v, int(u)) for v in range(n) for u in b.in_cols[v]
                  if u < n)
    assert got == want


def test_sampled_copy_spmm_matches_oracle(ds):
    b = NeighborSampler(ds.graph, [5, 3], seed=0).sample(np.arange(16))
    n = b.graph.n_nodes
    x0 = np.random.default_rng(0).normal(size=(n, 8)).astype(np.float32)
    cols = torch.from_numpy(b.in_cols)
    outs = []
    for fn in (lambda x: sampled_copy_spmm(cols, b.graph, x, reduce="mean"),
               lambda x: gspmm(b.graph, "copy_lhs", "mean", lhs=x,
                               lhs_target="u", to="dst")):
        x = torch.from_numpy(x0).requires_grad_()
        loss = (fn(x) ** 2).sum()
        loss.backward()
        outs.append((loss.item(), x.grad))
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-4)
    np.testing.assert_allclose(outs[0][1].numpy(), outs[1][1].numpy(),
                               rtol=1e-3, atol=1e-4)


def test_sampler_trims_instead_of_raising():
    ds2 = planted_partition(num_classes=2, nodes_per_class=30, feat_dim=4,
                            avg_degree=20, seed=3)
    s = NeighborSampler(ds2.graph, [20, 20], seed=0)
    b = s.sample(np.arange(30))
    assert b.graph.n_nodes == s.max_shapes(30)[0]
    assert b.node_ids[:30].tolist() == list(range(30))


def test_fit_sampled_fast_path_converges(ds):
    model = GraphSAGE(hidden_dim=16, out_dim=3, num_layers=2, in_dim=8)
    _, metrics = fit_sampled(model, ds, fanouts=(5, 3), batch_size=32,
                             epochs=12, learning_rate=1e-2, device="cpu")
    assert metrics["val_acc"] > 0.8, metrics


def _batch_invariants(b, g_full, fanouts, add_self_loops=True):
    from collections import Counter

    n = b.graph.n_nodes
    src, dst = _edges(b.graph)
    ids, n_local = b.node_ids, int(b.node_mask.sum())
    assert src.max(initial=-1) < n_local and dst.max(initial=-1) < n_local
    real_edges = set(zip(*(a.tolist() for a in _edges(g_full))))
    for u, v in zip(ids[src].tolist(), ids[dst].tolist()):
        if u == v and add_self_loops:
            continue
        assert (u, v) in real_edges
    want = Counter(zip(dst.tolist(), src.tolist()))
    got = Counter((v, int(u)) for v in range(n_local) for u in b.in_cols[v]
                  if u < n)
    assert got == want
    assert np.bincount(dst, minlength=n_local).max(initial=0) <= \
        max(fanouts) + 1


def test_native_and_fallback_sampler_invariants(ds, monkeypatch):
    seeds = np.arange(12)
    b_nat = NeighborSampler(ds.graph, [5, 3], seed=7).sample(seeds)
    _batch_invariants(b_nat, ds.graph, [5, 3])
    monkeypatch.setattr(native, "sample_subgraph_native",
                        lambda *a, **k: None)
    b_py = NeighborSampler(ds.graph, [5, 3], seed=7).sample(seeds)
    _batch_invariants(b_py, ds.graph, [5, 3])
    assert b_py.graph.n_nodes == b_nat.graph.n_nodes
    assert b_py.graph.num_edges_padded == b_nat.graph.num_edges_padded
    assert b_py.node_ids[:12].tolist() == b_nat.node_ids[:12].tolist()


def test_native_sampler_deterministic(ds):
    seeds = np.arange(16)
    b1 = NeighborSampler(ds.graph, [5, 3], seed=3).sample(seeds)
    b2 = NeighborSampler(ds.graph, [5, 3], seed=3).sample(seeds)
    np.testing.assert_array_equal(b1.node_ids, b2.node_ids)
    assert torch.equal(b1.graph.src, b2.graph.src)
    np.testing.assert_array_equal(b1.in_cols, b2.in_cols)
    b4 = NeighborSampler(ds.graph, [5, 3], seed=3, n_threads=4).sample(seeds)
    assert (sorted(zip(*(a.tolist() for a in _edges(b1.graph))))
            == sorted(zip(*(a.tolist() for a in _edges(b4.graph)))))


def test_sampler_thread_count_invariance(ds):
    assert native.available()
    b1, b4 = (NeighborSampler(ds.graph, [5, 3], seed=7, n_threads=nt)
              .sample(np.arange(24)) for nt in (1, 4))
    np.testing.assert_array_equal(b1.node_ids, b4.node_ids)
    np.testing.assert_array_equal(b1.in_cols, b4.in_cols)
    assert torch.equal(b1.graph.src, b4.graph.src)
    assert torch.equal(b1.graph.dst, b4.graph.dst)


def _assert_batches_equal(b, jb):
    for f in ("node_ids", "node_mask", "seed_ids", "seed_mask", "in_cols"):
        np.testing.assert_array_equal(getattr(b, f),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    assert b.num_seeds == jb.num_seeds
    for f in ("src", "dst", "indptr_r", "csc_perm", "csc_perm_inv",
              "indptr_c"):
        np.testing.assert_array_equal(getattr(b.graph, f).numpy(),
                                      np.asarray(getattr(jb.graph, f)),
                                      err_msg=f)
    assert (b.graph.n_nodes, b.graph.n_edges) == (jb.graph.n_nodes,
                                                  jb.graph.n_edges)


@pytest.mark.parametrize("path", ["native", "per_hop_native", "numpy"])
def test_batches_equal_jax_for_the_same_seed(ds, jds, path, monkeypatch):
    """Two batches and an epoch's first batch, both packages, one seed."""
    assert native.available() and jax_native.available()
    if path != "native":
        for mod in (native, jax_native):
            monkeypatch.setattr(mod, "sample_subgraph_native",
                                lambda *a, **k: None)
    if path == "numpy":
        for mod in (native, jax_native):
            monkeypatch.setattr(mod, "sample_in_edges_native",
                                lambda *a, **k: None)
    s = NeighborSampler(ds.graph, [5, 3], seed=11, n_threads=2)
    js = JaxSampler(jds.graph, [5, 3], seed=11, n_threads=2)
    for seeds in (np.arange(16), np.array([3, 100, 7, 150])):
        _assert_batches_equal(s.sample(seeds), js.sample(seeds))
    train = np.nonzero(ds.train_mask)[0]
    _assert_batches_equal(next(s.epoch(train, 32)),
                          next(js.epoch(train, 32)))


def test_sampled_copy_spmm_matches_jax(ds, jds):
    s = NeighborSampler(ds.graph, [5, 3], seed=0, n_threads=1)
    js = JaxSampler(jds.graph, [5, 3], seed=0, n_threads=1)
    b, jb = s.sample(np.arange(16)), js.sample(np.arange(16))
    n = b.graph.n_nodes
    x = np.random.default_rng(0).normal(size=(n, 8)).astype(np.float32)
    cot = np.random.default_rng(1).normal(size=(n, 8)).astype(np.float32)
    for reduce in ("sum", "mean"):
        jy, vjp = jax.vjp(lambda v: jax_sampled_copy_spmm(
            jnp.asarray(jb.in_cols), jb.graph, v, reduce=reduce),
            jnp.asarray(x))
        (jdx,) = vjp(jnp.asarray(cot))
        tx = torch.from_numpy(x).requires_grad_()
        y = sampled_copy_spmm(torch.from_numpy(b.in_cols), b.graph, tx,
                              reduce=reduce)
        y.backward(torch.from_numpy(cot))
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **TOL)


def test_one_sampled_sage_step_matches_jax(ds, jds):
    s = NeighborSampler(ds.graph, [5, 3], seed=0, n_threads=1)
    js = JaxSampler(jds.graph, [5, 3], seed=0, n_threads=1)
    seeds = np.nonzero(ds.train_mask)[0][:32]
    b, jb = s.sample(seeds), js.sample(seeds)
    jx = jnp.asarray(jds.features[jb.node_ids])
    jy = jnp.asarray(jds.labels[jb.seed_ids])
    jcols = jnp.asarray(jb.in_cols)
    jmodel = JaxSAGE(hidden_dim=16, out_dim=3, num_layers=2)
    params = jmodel.init(jax.random.PRNGKey(0), jb.graph, jx,
                         in_cols=jcols)["params"]

    def jloss(p):
        logits = jmodel.apply({"params": p}, jb.graph, jx, in_cols=jcols)
        return jax_masked_ce(logits[: len(seeds)], jy,
                             jnp.asarray(jb.seed_mask))

    jl, jgrads = jax.value_and_grad(jloss)(params)
    model = GraphSAGE(hidden_dim=16, out_dim=3, num_layers=2, in_dim=8)
    model.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    state = create_train_state(model, learning_rate=1e-2)
    x = torch.from_numpy(ds.features[b.node_ids])
    cols = torch.from_numpy(b.in_cols)
    logits = model(b.graph, x, in_cols=cols)
    assert unsafe_nodes(logits) == []
    with AtomicScan() as scan:
        loss = make_sampled_step()(
            state, b.graph, x,
            torch.from_numpy(ds.labels[b.seed_ids].astype(np.int64)),
            torch.from_numpy(b.seed_mask), cols)
    assert not scan.hits, scan.hits
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        w = want[name]
        err = float((p.grad - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()) + 1e-12, (name, err)


def _fit_dp(ds, **kw):
    from custom_op_benchmark_tpu_torch.parallel import make_mesh
    from custom_op_benchmark_tpu_torch.train import fit_sampled_dp

    mesh = make_mesh((4,), ("batch",), device="cpu")
    model = GraphSAGE(hidden_dim=16, out_dim=3, num_layers=2, in_dim=8)
    _, metrics = fit_sampled_dp(model, ds, mesh, fanouts=(5, 3),
                                batch_size=16, learning_rate=1e-2, **kw)
    return model, metrics


@pytest.mark.usefixtures("one_thread")
def test_fit_sampled_dp(ds):
    """Minibatch data parallelism: P = 4 sampled subgraphs a step, one a
    shard, the gradients averaged in shard order."""
    _, metrics = _fit_dp(ds, epochs=10)
    assert metrics["num_devices"] == 4
    assert metrics["val_acc"] > 0.8, metrics
    assert metrics["steps"] == len(metrics["losses"]) > 0


def _jax_dp_init(jds, fanouts, batch_size, seed):
    """JAX's ``fit_sampled_dp`` initial state, built as it builds it, and
    its model."""
    from custom_op_benchmark_tpu.train.loop import (
        create_train_state as jax_create_train_state,
    )

    jmodel = JaxSAGE(hidden_dim=16, out_dim=3, num_layers=2)
    train = np.nonzero(jds.train_mask)[0]
    b0 = JaxSampler(jds.graph, fanouts, seed=seed).sample(train[:batch_size])
    state = jax_create_train_state(
        jmodel, b0.graph, jnp.asarray(jds.features[b0.node_ids]),
        jax.random.PRNGKey(seed), learning_rate=1e-2,
        in_cols=jnp.asarray(b0.in_cols))
    return jmodel, state


def _port_from(params):
    """The port's GraphSAGE whose ``reset_parameters`` (which
    ``fit_sampled_dp`` calls) loads JAX's parameters."""
    model = GraphSAGE(hidden_dim=16, out_dim=3, num_layers=2, in_dim=8)
    sd = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    model.reset_parameters = lambda generator=None: model.load_state_dict(
        sd, strict=True)
    return model


@pytest.mark.usefixtures("one_thread")
def test_dp_step_gradient_is_the_mean_of_jax_shard_gradients(ds, jds):
    """The first step's averaged gradient against the mean of JAX's P = 4
    per-batch gradients at the same weights (each leaf within 1e-4 of its
    largest value) and the step's loss against their mean loss (1e-5
    relative): a gradient summed and not divided by P, a batch dropped,
    doubled or taken from another group would each fail here, where an
    Adam step hides the scale."""
    from custom_op_benchmark_tpu_torch.parallel import make_mesh
    from custom_op_benchmark_tpu_torch.train.loop import (
        dp_step,
        sampled_batches,
    )

    p, fanouts, bs = 4, (5, 3), 16
    jmodel, jstate = _jax_dp_init(jds, fanouts, bs, 0)
    train = np.nonzero(ds.train_mask)[0]
    jit = JaxSampler(jds.graph, fanouts, seed=5).epoch(train, bs)
    jgroup = [next(jit) for _ in range(p)]

    def jloss(prm, jb):
        logits = jmodel.apply({"params": prm}, jb.graph,
                              jnp.asarray(jds.features[jb.node_ids]),
                              in_cols=jnp.asarray(jb.in_cols))
        k = jb.seed_mask.shape[-1]
        return jax_masked_ce(logits[:k], jnp.asarray(jds.labels[jb.seed_ids]),
                             jnp.asarray(jb.seed_mask))

    per = [jax.value_and_grad(jloss)(jstate.params, jb) for jb in jgroup]
    want_loss = sum(float(l) for l, _ in per) / p
    want = flax_to_state_dict(jax.tree_util.tree_map(
        lambda *gs: sum(np.asarray(g, np.float64) for g in gs) / p,
        *[g for _, g in per]))

    model = _port_from(jstate.params)
    model.reset_parameters()
    state = create_train_state(model, learning_rate=1e-2)
    it = sampled_batches(NeighborSampler(ds.graph, fanouts, seed=5), train,
                         bs)
    group = [next(it) for _ in range(p)]
    for b, jb in zip(group, jgroup):
        np.testing.assert_array_equal(b[1], jb.node_ids)
    batches = [(g_b, torch.from_numpy(ids), torch.from_numpy(seeds),
                torch.from_numpy(mask), torch.from_numpy(cols))
               for g_b, ids, seeds, mask, cols in group]
    feats = torch.from_numpy(ds.features)
    labels = torch.from_numpy(ds.labels.astype(np.int64))
    mesh = make_mesh((p,), ("batch",), device="cpu")
    loss = dp_step(state, mesh, "batch", batches, feats, labels)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    for name, prm in model.named_parameters():
        w = want[name].float()
        err = float((prm.grad - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()) + 1e-12, (name, err)


@pytest.mark.usefixtures("one_thread")
def test_fit_sampled_dp_matches_jax(ds, jds):
    """JAX's ``fit_sampled_dp`` on a 4-wide batch axis of its 8-device CPU
    mesh and the port's on a local mesh of 4, from JAX's initial weights:
    every step's loss within 1e-4 relative, the final parameters within
    1e-4 of each leaf's largest value, the same ``num_devices``."""
    from custom_op_benchmark_tpu.parallel import make_mesh as jax_make_mesh
    from custom_op_benchmark_tpu.train import fit_sampled_dp as jax_fit_dp
    from custom_op_benchmark_tpu_torch.parallel import make_mesh
    from custom_op_benchmark_tpu_torch.train import fit_sampled_dp

    fanouts, bs, epochs = (5, 3), 16, 3
    jmodel, jstate0 = _jax_dp_init(jds, fanouts, bs, 0)
    jstate, jmetrics = jax_fit_dp(
        jmodel, jds, jax_make_mesh((4,), ("batch",)), fanouts=fanouts,
        batch_size=bs, epochs=epochs, learning_rate=1e-2)
    model = _port_from(jstate0.params)
    _, metrics = fit_sampled_dp(
        model, ds, make_mesh((4,), ("batch",), device="cpu"),
        fanouts=fanouts, batch_size=bs, epochs=epochs, learning_rate=1e-2)
    assert metrics["num_devices"] == jmetrics["num_devices"] == 4
    assert len(metrics["losses"]) == len(jmetrics["losses"]) > 0
    np.testing.assert_allclose(metrics["losses"], jmetrics["losses"],
                               rtol=1e-4)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                     jstate.params))
    for name, prm in model.named_parameters():
        w = want[name]
        err = float((prm.detach() - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (name, err)


@pytest.mark.usefixtures("one_thread")
def test_fit_sampled_dp_repeats_bit_for_bit(ds):
    """Two runs from one seed: equal losses and parameters, with no
    accumulating scatter in any step."""
    runs = []
    for _ in range(2):
        with AtomicScan() as scan:
            model, metrics = _fit_dp(ds, epochs=2)
        assert not scan.hits, scan.hits
        runs.append((metrics["losses"], list(model.parameters())))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
