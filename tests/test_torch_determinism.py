"""Bitwise reproducibility of the port (tests/test_determinism.py).

The four cases of the reference run twice through the port on the CPU and
must give equal tensors (``torch.equal``): the segment pipeline and its
gradients, the fused ELL attention and its gradient, the dense-block
attention, and two training runs (``fit_full_graph`` of a GAT) on the
segment path, on ELL and on dense blocks. The JAX package runs the same
cases on the same numpy inputs, and the port's results agree with its
within 1e-4 for the segment pipeline (its squared-output gradients sum
hub rows of a power-law graph) and 1e-5 for the ELL attention: f32 sums
in other orders.

On the card a sum with atomics adds in an order that changes from run to
run; on the CPU the same operations mostly run in order, so a repeat alone
can miss them. So each case also runs under :class:`AtomicScan`, which
sees every operation of the forward and the backward and fails on any
accumulating scatter (``index_add``, ``scatter_add``, ``index_put`` with
``accumulate=True``, ``embedding_dense_backward``) whose index repeats,
and :func:`unsafe_nodes` walks each autograd graph for a backward of a
gather (``IndexBackward0``, ``IndexSelectBackward0``, ``GatherBackward0``,
``EmbeddingBackward0``) over an index that repeats: the atomic backward
that autograd would add on its own. A gather by a permutation is allowed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from custom_op_benchmark_tpu import ops as jops
from custom_op_benchmark_tpu.graph import random_graph as jax_random_graph
from custom_op_benchmark_tpu_torch import ops as tops
from custom_op_benchmark_tpu_torch.data import planted_partition
from custom_op_benchmark_tpu_torch.data.synthetic import (
    NodeClassificationDataset,
)
from custom_op_benchmark_tpu_torch.graph import (
    block_graph,
    clique_batch,
    random_graph,
)
from custom_op_benchmark_tpu_torch.models import (
    GAT,
    GATDGL,
    GCN,
    GIN,
    GraphSAGE,
)
from custom_op_benchmark_tpu_torch.train import (
    fit_full_graph,
    masked_cross_entropy,
)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def one_thread():
    """One intra-op thread for a module's tests, restored after it: the
    tier-1 run's six workers share the machine, and many small ops on
    many threads each spin against the other workers (a training test of
    2.5 s alone took 300 s so)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)

# Autograd's backward of a gather: over a repeated index it accumulates
# with index_put_(accumulate=True) / embedding_dense_backward, atomics on
# the card.
GATHER_BACKWARDS = {
    "IndexBackward0": "_saved_indices",
    "IndexSelectBackward0": "_saved_index",
    "GatherBackward0": "_saved_index",
    "EmbeddingBackward0": "_saved_indices",
}


def _repeats(index: torch.Tensor, dim: int = 0) -> bool:
    """True if two entries of ``index`` along ``dim`` name the same row
    (for a multi-dimensional gather index, within one column)."""
    if index.dtype == torch.bool or index.numel() < 2:
        return False
    if dim >= 2 ** 63:           # a saved negative dim reads as unsigned
        dim -= 2 ** 64
    cols = index.movedim(dim, 0).reshape(index.shape[dim], -1)
    srt = cols.sort(0).values
    return bool((srt[1:] == srt[:-1]).any())


def unsafe_nodes(root) -> list:
    """Names of the gather backwards over a repeated index in the autograd
    graph below ``root`` (a tensor or its ``grad_fn``)."""
    fn = root.grad_fn if isinstance(root, torch.Tensor) else root
    seen, stack, bad = set(), [fn], []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        name = type(node).__name__
        attr = GATHER_BACKWARDS.get(name)
        if attr is not None:
            idx = getattr(node, attr)
            idx = [t for t in (idx if isinstance(idx, (list, tuple))
                               else [idx]) if t is not None]
            dim = getattr(node, "_saved_dim", 0) if name != "IndexBackward0" \
                else 0
            if any(_repeats(t, dim) for t in idx):
                bad.append(name)
        stack.extend(f for f, _ in node.next_functions)
    return bad


class AtomicScan(TorchDispatchMode):
    """Records every accumulating scatter over a repeated index that runs
    inside the block, forward or backward (``hits``)."""

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        hit = False
        if name in ("aten::index_add", "aten::index_add_"):
            hit = _repeats(args[2])
        elif name in ("aten::scatter_add", "aten::scatter_add_"):
            hit = _repeats(args[2], args[1])
        elif name in ("aten::index_put", "aten::index_put_",
                      "aten::_index_put_impl_"):
            acc = args[3] if len(args) > 3 else kwargs.get("accumulate",
                                                           False)
            hit = bool(acc) and any(t is not None and _repeats(t)
                                    for t in args[1])
        elif name == "aten::embedding_dense_backward":
            hit = _repeats(args[1].reshape(-1))
        if hit:
            self.hits.append(name)
        return func(*args, **kwargs)


def _no_atomics(fn):
    """Run ``fn()`` (forward and backward) under AtomicScan and return its
    result; fails on any accumulating scatter over a repeated index."""
    with AtomicScan() as scan:
        out = fn()
    assert not scan.hits, f"accumulating scatters: {sorted(set(scan.hits))}"
    return out


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def data():
    g = random_graph(200, 2000, seed=0, power_law=True)
    jg = jax_random_graph(200, 2000, seed=0, power_law=True)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(g.n_nodes, 16)).astype(np.float32)
    ed = rng.uniform(size=g.num_edges_padded).astype(np.float32)
    return g, jg, x, ed


def test_segment_ops_bitwise_reproducible(data):
    g, jg, x, ed = data

    def pipeline(ops, gr, ed, x, impl):
        s = ops.sddmm(gr, x, x, impl=impl)
        a = ops.edge_softmax(gr, s, by="dst", impl=impl)
        return ops.vector_spmm(gr, a * ed, x, impl=impl)

    def run():
        te = torch.from_numpy(ed).requires_grad_()
        tx = torch.from_numpy(x).requires_grad_()
        y = pipeline(tops, g, te, tx, "xla")
        assert unsafe_nodes(y) == []
        loss = (y ** 2).sum()
        de, dx = torch.autograd.grad(loss, (te, tx))
        return [y.detach(), de, dx]

    first, second = _no_atomics(run), _no_atomics(run)
    _equal(first, second)
    jy = pipeline(jops, jg, jnp.asarray(ed), jnp.asarray(x), "xla")
    jde, jdx = jax.grad(lambda e, v: (pipeline(jops, jg, e, v, "xla") ** 2)
                        .sum(), argnums=(0, 1))(jnp.asarray(ed),
                                                jnp.asarray(x))
    for got, want in zip(first, (jy, jde, jdx)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


def test_ell_attention_bitwise_reproducible(data):
    g, jg, x, _ = data
    se, de = tops.ell_dual(g)
    jse, jde = jops.ell_dual(jg)

    def run():
        q = torch.from_numpy(x).requires_grad_()
        y = tops.ell_attention(de, se, q, q, q)
        assert unsafe_nodes(y) == []
        (dq,) = torch.autograd.grad((y ** 2).sum(), (q,))
        return [y.detach(), dq]

    first, second = _no_atomics(run), _no_atomics(run)
    _equal(first, second)
    jq = jnp.asarray(x)
    np.testing.assert_allclose(
        first[0].numpy(), np.asarray(jops.ell_attention(jde, jse, jq, jq, jq)),
        **TOL)


def test_block_attention_bitwise_reproducible():
    g = clique_batch(4, 8)
    bg = block_graph(g)
    x = np.random.default_rng(0).normal(size=(g.n_nodes, 8)).astype(
        np.float32)

    def run():
        xb = bg.scatter_nodes(torch.from_numpy(x).requires_grad_())
        y = tops.block_attention(bg, xb, xb, xb)
        assert unsafe_nodes(y) == []
        (dxb,) = torch.autograd.grad((y ** 2).sum(), (xb,))
        return [y.detach(), dxb]

    _equal(_no_atomics(run), _no_atomics(run))


def _cliques_dataset():
    g = clique_batch(8, 10)
    rng = np.random.default_rng(0)
    n = g.n_nodes
    train = rng.random(n) < 0.6
    return NodeClassificationDataset(
        graph=g, features=rng.normal(size=(n, 8)).astype(np.float32),
        labels=rng.integers(0, 3, size=n).astype(np.int32),
        train_mask=train, val_mask=~train, test_mask=np.zeros(n, bool),
        num_classes=3, name="cliques")


@pytest.mark.parametrize("strategy", [None, "ell", "block"])
def test_training_bitwise_reproducible(strategy):
    """Two identical training runs give bit-identical parameters."""
    ds = (_cliques_dataset() if strategy == "block" else
          planted_partition(num_classes=3, nodes_per_class=20, feat_dim=8,
                            seed=0))

    def fit():
        model = GAT(hidden_dim=8, out_dim=3, num_heads=2,
                    in_dim=ds.features.shape[1])
        return fit_full_graph(model, ds, epochs=10, seed=7,
                              strategy=strategy, device="cpu")

    (s1, m1), (s2, m2) = _no_atomics(fit), _no_atomics(fit)
    assert m1["val_loss"] == m2["val_loss"]
    _equal(list(s1.model.parameters()), list(s2.model.parameters()))


@pytest.mark.parametrize("arch", ["GAT", "GATDGL", "GCN", "GraphSAGE",
                                  "GIN"])
@pytest.mark.parametrize("path", ["segment", "ell"])
def test_model_paths_have_no_atomic_backward(arch, path):
    """Every model's segment and ELL paths: no gather backward over a
    repeated index in the autograd graph, no accumulating scatter in the
    forward or backward, and equal gradients on a repeat."""
    ds = planted_partition(num_classes=3, nodes_per_class=20, feat_dim=8,
                           seed=0, pad_multiple=64)
    g = ds.graph
    views = {"ell": tops.ell_dual(g, profile="train")} if path == "ell" \
        else {}
    kw = dict(num_heads=2) if arch in ("GAT", "GATDGL") else {}
    model = {"GAT": GAT, "GATDGL": GATDGL, "GCN": GCN, "GraphSAGE": GraphSAGE,
             "GIN": GIN}[arch](hidden_dim=8, out_dim=3, in_dim=8, **kw,
                               generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(ds.features)
    labels = torch.from_numpy(ds.labels)
    mask = torch.from_numpy(ds.train_mask)

    def run():
        logits = model(g, x, **views)
        loss = masked_cross_entropy(logits, labels, mask)
        assert unsafe_nodes(loss) == []
        return list(torch.autograd.grad(loss, list(model.parameters())))

    _equal(_no_atomics(run), _no_atomics(run))


def test_scan_and_walk_catch_an_atomic_gather():
    """The checks themselves: a gather over repeated ids, differentiated by
    autograd, is caught by both; a gather by a permutation by neither."""
    x = torch.randn(4, 3, requires_grad=True)
    rep = x[torch.tensor([0, 1, 1, 3])]
    perm = x[torch.tensor([2, 0, 3, 1])]
    assert unsafe_nodes(rep) == ["IndexBackward0"]
    assert unsafe_nodes(perm) == []
    with AtomicScan() as scan:
        rep.sum().backward()
    assert scan.hits
    with AtomicScan() as scan:
        torch.zeros(4).index_add_(0, torch.tensor([0, 2]), torch.ones(2))
        perm.sum().backward()
    assert not scan.hits


def _dist_cases():
    """The distributed plans' ops (parallel/), each a function of a seed
    that returns its output and every gradient."""
    from custom_op_benchmark_tpu_torch.graph import random_graph as rg
    from custom_op_benchmark_tpu_torch.parallel import (
        halo,
        make_mesh,
        shard_ops,
        tp,
    )

    g = rg(96, 800, seed=2, power_law=True)
    mesh = make_mesh((4,), ("edge",), device="cpu")
    hg = halo.halo_graph(g, mesh, hub_threshold=2)
    he = halo.halo_ell(hg, mesh)
    dg = shard_ops.dist_graph(g, mesh)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(g.n_nodes, 2, 4)).astype(np.float32)
    ed = rng.uniform(size=g.num_edges_padded).astype(np.float32)

    def hnodes(a):
        return halo.shard_halo_nodes(hg, mesh, a).requires_grad_()

    def gnodes(a):
        return shard_ops.shard_nodes(dg, mesh, a).requires_grad_()

    def hedges():
        return halo.halo_edge_data(hg, mesh, ed).requires_grad_()

    def gedges():
        return shard_ops.shard_edges(dg, mesh, np.stack([ed[: g.n_edges]] * 2,
                                                        1)).requires_grad_()

    se, de = tops.ell_dual(g)
    mesh_h = make_mesh((2,), ("head",), device="cpu")
    return {
        "halo_spmm": lambda: (halo.halo_spmm, (hg, mesh), (hedges(),
                                                           hnodes(x[:, 0]))),
        "halo_gat_attention": lambda: (halo.halo_gat_attention, (hg, mesh),
                                       (hnodes(x), hnodes(x), hnodes(x))),
        "halo_attention_ell": lambda: (halo.halo_attention_ell,
                                       (hg, he, mesh),
                                       (hnodes(x), hnodes(x), hnodes(x))),
        "halo_spmm_ell": lambda: (halo.halo_spmm_ell, (hg, he, mesh),
                                  (hedges(), hnodes(x[:, 0]))),
        "dist_sddmm": lambda: (shard_ops.dist_sddmm, (dg, mesh),
                               (gnodes(x), gnodes(x))),
        "dist_edge_softmax": lambda: (shard_ops.dist_edge_softmax,
                                      (dg, mesh), (gedges(),)),
        "dist_vector_spmm": lambda: (shard_ops.dist_vector_spmm, (dg, mesh),
                                     (gedges(), gnodes(x))),
        "dist_gat_attention": lambda: (shard_ops.dist_gat_attention,
                                       (dg, mesh),
                                       (gnodes(x), gnodes(x), gnodes(x))),
        "tp_attention": lambda: (tp.tp_attention, (de, se, mesh_h),
                                 tuple(torch.from_numpy(x).requires_grad_()
                                       for _ in range(3))),
    }


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("op", sorted(_dist_cases()))
def test_distributed_ops_have_no_atomic_backward(op):
    """Every op of the distributed plans on a local mesh (a hub plan for
    the halo ops): no gather backward over a repeated index, no
    accumulating scatter forward or backward, and equal bits on a
    repeat."""
    make = _dist_cases()[op]

    def run():
        fn, lead, args = make()
        y = fn(*lead, *args)
        assert unsafe_nodes(y) == []
        return [y.detach()] + list(torch.autograd.grad((y ** 2).sum(),
                                                       args))

    _equal(_no_atomics(run), _no_atomics(run))


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("arch", ["gat", "transformer"])
def test_edge_partitioned_training_bitwise_reproducible(arch):
    """Two runs of fit_edge_partitioned (halo plan) give equal parameters
    and metrics, with no accumulating scatter."""
    from custom_op_benchmark_tpu_torch.parallel import (
        fit_edge_partitioned,
        make_mesh,
    )

    ds = planted_partition(num_classes=3, nodes_per_class=20, feat_dim=8,
                           seed=0)

    def fit():
        return fit_edge_partitioned(
            ds, make_mesh((4,), ("edge",), device="cpu"), hidden=8,
            num_heads=2, num_layers=2, epochs=3, arch=arch)

    (p1, m1), (p2, m2) = _no_atomics(fit), _no_atomics(fit)
    assert m1["loss"] == m2["loss"]
    _equal(list(p1.parameters()), list(p2.parameters()))
