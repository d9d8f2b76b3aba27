"""The port's ELL strategy (graph/ell.py, ops/ell.py) against the JAX
package's, on the same numpy inputs.

The cases of tests/test_ell.py, each held to the JAX package's ELL ops
(forward and gradient) at that file's tolerances: 1e-4 for forwards,
1e-3 to 2e-3 for gradients; the cases of tests/test_packing_properties.py
(its halo plan case is in tests/test_torch_halo_native.py) on the port's
packing, whose arrays also equal JAX's bit for bit on both width ladders; and the
``impl="ell"`` routes of the public ops against the port's segment oracle.
The CUDA kernel S3 under ``ell_copy_spmm`` runs its plain version here, as
the tensors lie on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from custom_op_benchmark_tpu.graph import (
    clique_batch as jax_clique_batch,
    from_coo as jax_from_coo,
    random_graph as jax_random_graph,
)
from custom_op_benchmark_tpu.graph.ell import ell_pack as jax_ell_pack
from custom_op_benchmark_tpu.ops import ell as J
from custom_op_benchmark_tpu.ops import (
    gspmm as jax_gspmm,
    vector_spmm as jax_vector_spmm,
)
from custom_op_benchmark_tpu_torch.graph import (
    TRAIN_WIDTHS,
    clique_batch,
    ell_pack,
    from_coo,
    random_graph,
)
from custom_op_benchmark_tpu_torch.ops import (
    PackedEdgeWeights,
    attention,
    edge_softmax,
    ell_attention,
    ell_copy_spmm,
    ell_cross_packed,
    ell_dual,
    ell_edge_bias_attention,
    ell_gat_attention,
    ell_gather_edges,
    ell_node_mul_edge,
    ell_pack_weights,
    ell_scatter_edges,
    ell_sddmm,
    ell_softmax,
    ell_spmm,
    ell_unpack_weights,
    gat_attention,
    node_mul_edge,
    sddmm,
    vector_spmm,
)

RTOL, ATOL = 1e-4, 1e-4
WIDTHS = (4, 16, 64, 256)


@pytest.fixture(scope="module", params=["power_law", "clique"])
def setup(request):
    """Both packages' graph and dual packing (``widths=(4, 16, 64, 256)``)."""
    if request.param == "power_law":
        g = random_graph(300, 3000, seed=1, power_law=True)
        jg = jax_random_graph(300, 3000, seed=1, power_law=True)
    else:
        g, jg = clique_batch(6, 9), jax_clique_batch(6, 9)
    return dict(g=g, jg=jg, ell=ell_dual(g, widths=WIDTHS),
                jell=J.ell_dual(jg, widths=WIDTHS))


def _rand(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _value_and_grads_torch(fn, *arrays):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    out.backward()
    return out.item(), [t.grad.numpy() for t in ts]


def _value_and_grads_jax(fn, *arrays):
    v, g = jax.value_and_grad(fn, argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    return float(v), [np.asarray(a) for a in g]


def _close(got, want, tol=(RTOL, ATOL), rows=None):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got)[:rows],
                               np.asarray(want)[:rows], rtol=tol[0],
                               atol=tol[1])


def _assert_packing_equal(eg, jeg):
    assert len(eg.buckets) == len(jeg.buckets)
    for b, jb in zip(eg.buckets, jeg.buckets):
        assert (b.width, b.num_rows) == (jb.width, jb.num_rows)
        for name in ("rows", "cols", "eid"):
            np.testing.assert_array_equal(getattr(b, name).numpy(),
                                          np.asarray(getattr(jb, name)))
    np.testing.assert_array_equal(eg.row_pos.numpy(), np.asarray(jeg.row_pos))
    np.testing.assert_array_equal(eg.edge_pos.numpy(),
                                  np.asarray(jeg.edge_pos))
    assert (eg.total_rows, eg.total_slots, eg.n_nodes, eg.n_edges,
            eg.num_edges_padded) == (jeg.total_rows, jeg.total_slots,
                                     jeg.n_nodes, jeg.n_edges,
                                     jeg.num_edges_padded)
    assert eg.padding_waste == jeg.padding_waste
    if jeg.twin_slot is not None:
        for t, jt in zip(eg.twin_slot, jeg.twin_slot):
            np.testing.assert_array_equal(t.numpy(), np.asarray(jt))


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

def test_pack_covers_all_edges(setup):
    g = setup["g"]
    for eg in setup["ell"]:
        eids = torch.cat([b.eid.reshape(-1) for b in eg.buckets]).numpy()
        real = np.sort(eids[eids < g.num_edges_padded])
        expected = (np.arange(g.n_edges) if eg.direction == "src"
                    else np.sort(g.csc_perm.numpy()[: g.n_edges]))
        np.testing.assert_array_equal(real, np.sort(expected))
        assert eg.padding_waste < 4.5


@pytest.mark.parametrize("ladder", ["fixture", "pow2", "train"])
def test_packing_matches_jax_bit_for_bit(setup, ladder):
    g, jg = setup["g"], setup["jg"]
    if ladder == "fixture":
        ours, theirs = setup["ell"], setup["jell"]
    elif ladder == "pow2":
        ours, theirs = ell_dual(g), J.ell_dual(jg)
    else:
        ours = ell_dual(g, profile="train")
        theirs = J.ell_dual(jg, profile="train")
        assert [b.width for b in ours[0].buckets] == [
            w for w in TRAIN_WIDTHS if w in [b.width for b in ours[0].buckets]]
    for eg, jeg in zip(ours, theirs):
        _assert_packing_equal(eg, jeg)


def test_profile_must_be_train():
    with pytest.raises(ValueError, match="profile"):
        ell_dual(clique_batch(2, 3), profile="infer")


# ---------------------------------------------------------------------------
# SpMM, SDDMM, softmax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multihead", [False, True])
def test_ell_spmm_fwd_bwd(setup, multihead):
    g = setup["g"]
    (se, de), (jse, jde) = setup["ell"], setup["jell"]
    n, e, e_pad = g.n_nodes, g.n_edges, g.num_edges_padded
    ed = _rand(1, (e_pad, 2) if multihead else (e_pad,))
    x = _rand(2, (n, 2, 8) if multihead else (n, 8))
    ed[e:] = 0
    got = _value_and_grads_torch(
        lambda ed, x: (ell_spmm(se, de, ed, x) ** 2).sum(), ed, x)
    want = _value_and_grads_jax(
        lambda ed, x: (J.ell_spmm(jse, jde, ed, x) ** 2).sum(), ed, x)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3)
    _close(got[1][0], want[1][0], (1e-3, 1e-3), rows=e)
    _close(got[1][1], want[1][1], (1e-3, 1e-3))


@pytest.mark.parametrize("multihead", [False, True])
def test_ell_sddmm_fwd_bwd(setup, multihead):
    g = setup["g"]
    (se, de), (jse, jde) = setup["ell"], setup["jell"]
    n, e, e_pad = g.n_nodes, g.n_edges, g.num_edges_padded
    shape = (n, 2, 8) if multihead else (n, 8)
    A, B = _rand(3, shape), _rand(4, shape)
    dy = _rand(5, (e_pad, 2) if multihead else (e_pad,))
    s = ell_sddmm(se, de, torch.from_numpy(A), torch.from_numpy(B))
    _close(s, J.ell_sddmm(jse, jde, jnp.asarray(A), jnp.asarray(B)),
           rows=e)
    got = _value_and_grads_torch(
        lambda A, B: (ell_sddmm(se, de, A, B) * torch.from_numpy(dy)).sum(),
        A, B)
    want = _value_and_grads_jax(
        lambda A, B: (J.ell_sddmm(jse, jde, A, B) * dy).sum(), A, B)
    for a, b in zip(got[1], want[1]):
        _close(a, b, (1e-3, 1e-3))


@pytest.mark.parametrize("direction", ["src", "dst"])
def test_ell_softmax_fwd_bwd(setup, direction):
    g = setup["g"]
    ell = setup["ell"][0 if direction == "src" else 1]
    jell = setup["jell"][0 if direction == "src" else 1]
    e, e_pad = g.n_edges, g.num_edges_padded
    x, dy = _rand(6, (e_pad,)), _rand(7, (e_pad,))
    _close(ell_softmax(ell, torch.from_numpy(x)), J.ell_softmax(jell, x),
           rows=e)
    got = _value_and_grads_torch(
        lambda x: (ell_softmax(ell, x) * torch.from_numpy(dy)).sum(), x)
    want = _value_and_grads_jax(
        lambda x: (J.ell_softmax(jell, x) * dy).sum(), x)
    _close(got[1][0], want[1][0], (1e-3, 1e-4), rows=e)


def test_ell_attention_composition(setup):
    """SDDMM → softmax → SpMM composed on the ELL ops, as JAX composes
    them."""
    g = setup["g"]
    (se, de), (jse, jde) = setup["ell"], setup["jell"]
    q, k, v = (_rand(s, (g.n_nodes, 8)) for s in (8, 9, 10))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    a = ell_softmax(se, ell_sddmm(se, de, tq, tk) / np.sqrt(8.0))
    y = ell_spmm(se, de, a, tv)
    ja = J.ell_softmax(jse, J.ell_sddmm(jse, jde, q, k) / jnp.sqrt(8.0))
    _close(y, J.ell_spmm(jse, jde, ja, v), (1e-3, 1e-4))


# ---------------------------------------------------------------------------
# Fused attention and GAT
# ---------------------------------------------------------------------------

def test_ell_fused_attention_fwd_bwd(setup):
    g = setup["g"]
    (se, de), (jse, jde) = setup["ell"], setup["jell"]
    q, k, v = (_rand(s, (g.n_nodes, 8)) for s in (11, 12, 13))
    got = _value_and_grads_torch(
        lambda q, k, v: (ell_attention(de, se, q, k, v) ** 2).sum(), q, k, v)
    want = _value_and_grads_jax(
        lambda q, k, v: (J.ell_attention(jde, jse, q, k, v) ** 2).sum(),
        q, k, v)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3)
    for a, b in zip(got[1], want[1]):
        _close(a, b, (2e-3, 2e-3))


def test_ell_fused_attention_multihead(setup):
    g = setup["g"]
    (se, de), (jse, jde) = setup["ell"], setup["jell"]
    q, k, v = (_rand(s, (g.n_nodes, 2, 8)) for s in (14, 15, 16))
    y = ell_attention(de, se, *map(torch.from_numpy, (q, k, v)))
    _close(y, J.ell_attention(jde, jse, q, k, v), (1e-3, 1e-3))


def test_ell_gat_attention_fwd_bwd(setup):
    g = setup["g"]
    (se, de), (jse, jde) = setup["ell"], setup["jell"]
    h, d = 2, 8
    a_l, a_r = _rand(17, (h, d)), _rand(18, (h, d))
    z = _rand(19, (g.n_nodes, h, d))
    got = _value_and_grads_torch(
        lambda a, b, z: (ell_gat_attention(de, se, a, b, z) ** 2).sum(),
        a_l, a_r, z)
    want = _value_and_grads_jax(
        lambda a, b, z: (J.ell_gat_attention(jde, jse, a, b, z) ** 2).sum(),
        a_l, a_r, z)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3)
    for a, b in zip(got[1], want[1]):
        _close(a, b, (2e-3, 2e-3))


# ---------------------------------------------------------------------------
# Copy-SpMM (S3) and NodeMulEdge
# ---------------------------------------------------------------------------

def test_ell_copy_spmm_and_node_mul_edge(setup):
    g, jg = setup["g"], setup["jg"]
    (se, de), (jse, jde) = setup["ell"], setup["jell"]
    n, e = g.n_nodes, g.n_edges
    x = _rand(20, (n, 8))
    for reduce in ("sum", "mean"):
        y = ell_copy_spmm(de, se, torch.from_numpy(x), reduce=reduce)
        _close(y, J.ell_copy_spmm(jde, jse, jnp.asarray(x), reduce=reduce))
        _close(y, jax_gspmm(jg, "copy_lhs", reduce, lhs=jnp.asarray(x),
                            lhs_target="u", to="dst"))
    # The VJP of the copy-sum is the transpose copy-sum.
    got = _value_and_grads_torch(
        lambda x: (ell_copy_spmm(de, se, x) ** 2).sum(), x)
    want = _value_and_grads_jax(
        lambda x: (J.ell_copy_spmm(jde, jse, x) ** 2).sum(), x)
    _close(got[1][0], want[1][0], (1e-3, 1e-3))
    A = _rand(21, (n, 2, 8))
    Be = _rand(22, (g.num_edges_padded, 8))
    s = ell_node_mul_edge(se, de, torch.from_numpy(A), torch.from_numpy(Be))
    _close(s, J.ell_node_mul_edge(jse, jde, A, Be), rows=e)


class _OpNames(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("multihead", [False, True])
def test_ell_node_mul_edge_grads_gather_only(setup, multihead):
    """Gradients match JAX's, and the backward runs no scatter."""
    g = setup["g"]
    (se, de), (jse, jde) = setup["ell"], setup["jell"]
    n, e = g.n_nodes, g.n_edges
    A = _rand(23, (n, 2, 8) if multihead else (n, 8))
    Be = _rand(24, (e, 8))
    w = _rand(25, (e,) + ((2,) if multihead else ()))

    def loss(A, Be):
        s = ell_node_mul_edge(se, de, A, Be)[:e]
        return (s * torch.from_numpy(w)).sum() + (s ** 2).sum()

    def jloss(A, Be):
        s = J.ell_node_mul_edge(jse, jde, A, Be)[:e]
        return (s * w).sum() + (s ** 2).sum()

    got = _value_and_grads_torch(loss, A, Be)
    want = _value_and_grads_jax(jloss, A, Be)
    for a, b in zip(got[1], want[1]):
        _close(a, b, (1e-3, 1e-4))
    tA = torch.from_numpy(A).requires_grad_()
    tB = torch.from_numpy(Be).requires_grad_()
    out = loss(tA, tB)
    with _OpNames() as rec:
        out.backward()
    bad = [f for f in rec.names
           if "scatter" in f or "index_add" in f or "index_put" in f]
    assert not bad, bad


# ---------------------------------------------------------------------------
# Models on the ELL path
# ---------------------------------------------------------------------------

def _converted(jmodel, model, jg, x, *extra):
    from custom_op_benchmark_tpu_torch.models import flax_to_state_dict

    params = jmodel.init(jax.random.PRNGKey(0), jg, jnp.asarray(x),
                         *extra)["params"]
    model.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    return params


def test_gat_model_ell_path_matches(setup):
    from custom_op_benchmark_tpu.models import GAT as JaxGAT
    from custom_op_benchmark_tpu_torch.models import GAT

    g, jg = setup["g"], setup["jg"]
    x = _rand(26, (g.n_nodes, 12))
    jmodel = JaxGAT(hidden_dim=8, out_dim=3, num_layers=2, num_heads=2)
    model = GAT(hidden_dim=8, out_dim=3, num_layers=2, num_heads=2, in_dim=12)
    params = _converted(jmodel, model, jg, x)
    y_seg = np.asarray(jmodel.apply({"params": params}, jg, jnp.asarray(x)))
    tx = torch.from_numpy(x)
    _close(model(g, tx, ell=setup["ell"]), y_seg, (2e-3, 2e-3))
    _close(model(g, tx), y_seg, (2e-3, 2e-3))


def test_fit_full_graph_ell_strategy():
    from custom_op_benchmark_tpu_torch.data import planted_partition
    from custom_op_benchmark_tpu_torch.models import GAT
    from custom_op_benchmark_tpu_torch.train import fit_full_graph

    ds = planted_partition(num_classes=3, nodes_per_class=30, feat_dim=16,
                           seed=1)
    model = GAT(hidden_dim=16, out_dim=3, num_heads=2, in_dim=16)
    _, metrics = fit_full_graph(model, ds, epochs=40, learning_rate=1e-2,
                                strategy="ell", device="cpu")
    assert metrics["val_acc"] > 0.8, metrics


def test_gcn_sage_ell_paths_match(setup):
    from custom_op_benchmark_tpu.models import GCN as JaxGCN
    from custom_op_benchmark_tpu.models import GraphSAGE as JaxSAGE
    from custom_op_benchmark_tpu_torch.models import GCN, GraphSAGE

    g, jg = setup["g"], setup["jg"]
    x = _rand(27, (g.n_nodes, 12))
    for jcls, cls in ((JaxGCN, GCN), (JaxSAGE, GraphSAGE)):
        jmodel = jcls(hidden_dim=8, out_dim=3)
        model = cls(hidden_dim=8, out_dim=3, in_dim=12)
        params = _converted(jmodel, model, jg, x)
        y_seg = np.asarray(jmodel.apply({"params": params}, jg,
                                        jnp.asarray(x)))
        _close(model(g, torch.from_numpy(x), ell=setup["ell"]), y_seg,
               (2e-3, 2e-3))


def test_transformer_edge_feat_ell_path(setup):
    from custom_op_benchmark_tpu.models import (
        GraphTransformer as JaxTransformer,
    )
    from custom_op_benchmark_tpu_torch.models import GraphTransformer

    g, jg = setup["g"], setup["jg"]
    x = _rand(28, (g.n_nodes, 16))
    be = _rand(29, (g.num_edges_padded, 8))        # head_dim = 8
    jmodel = JaxTransformer(dim=16, num_heads=2, num_layers=1)
    model = GraphTransformer(16, 2, 1)
    params = _converted(jmodel, model, jg, x, jnp.asarray(be))
    y_seg = np.asarray(jmodel.apply({"params": params}, jg, jnp.asarray(x),
                                    jnp.asarray(be)))
    y = model(g, torch.from_numpy(x), torch.from_numpy(be),
              ell=setup["ell"])
    _close(y, y_seg, (2e-3, 2e-3))


# ---------------------------------------------------------------------------
# Edge cases
# ---------------------------------------------------------------------------

def test_ell_ops_on_edgeless_graph():
    """Zero-edge graphs give zeros (and zero gradients), not a crash."""
    g = from_coo(np.array([], np.int64), np.array([], np.int64), n_nodes=6)
    se, de = ell_dual(g)
    assert not se.buckets and not de.buckets
    x = torch.ones(6, 4)
    xh = torch.ones(6, 2, 4)
    ed = torch.ones(max(g.num_edges_padded, 1))
    assert not ell_spmm(se, de, ed, x).any()
    assert not ell_sddmm(se, de, x, x).any()
    assert not ell_attention(de, se, x, x, x).any()
    assert not ell_copy_spmm(de, se, x).any()
    assert not ell_copy_spmm(de, se, x, reduce="mean").any()
    a = torch.ones(2, 4)
    assert not ell_gat_attention(de, se, a, a, xh).any()
    be = torch.ones(max(g.num_edges_padded, 1), 4)
    assert not ell_node_mul_edge(se, de, xh, be).any()
    assert not ell_edge_bias_attention(de, se, x, x, x, be).any()
    z = xh.clone().requires_grad_()
    (ell_gat_attention(de, se, a, a, z) ** 2).sum().backward()
    assert not z.grad.any()


def test_ell_multigraph_semantics():
    """Duplicate edges are kept: each contributes its own term."""
    src, dst = np.array([0, 0, 0, 1]), np.array([1, 1, 2, 2])
    g, jg = from_coo(src, dst, n_nodes=3), jax_from_coo(src, dst, n_nodes=3)
    se, de = ell_dual(g)
    x = np.arange(6, dtype=np.float32).reshape(3, 2) + 1
    ed = np.ones(g.num_edges_padded, np.float32)
    y = ell_spmm(se, de, torch.from_numpy(ed), torch.from_numpy(x))
    _close(y, jax_vector_spmm(jg, jnp.asarray(ed), jnp.asarray(x)),
           (1e-6, 1e-6))
    np.testing.assert_allclose(y[0].numpy(), 2 * x[1] + x[2])
    # The twin hop on a multigraph: both copies of (0, 1) land on their own
    # slots, the pad slots read zero.
    packed = ell_scatter_edges(se, torch.arange(1.0, 5.0))
    back = ell_gather_edges(de, ell_cross_packed(se, de, packed))
    np.testing.assert_array_equal(back.numpy(), [1.0, 2.0, 3.0, 4.0])


def test_ell_cross_packed_roundtrip(setup):
    g = setup["g"]
    (se, de), (jse, jde) = setup["ell"], setup["jell"]
    ed = _rand(30, (g.num_edges_padded,))
    packed_dst = ell_cross_packed(se, de,
                                  ell_scatter_edges(se, torch.from_numpy(ed)))
    back = ell_gather_edges(de, packed_dst)
    np.testing.assert_array_equal(back.numpy()[: g.n_edges], ed[: g.n_edges])
    jpacked = J.ell_cross_packed(jse, jde, J.ell_scatter_edges(jse, ed))
    for a, b in zip(packed_dst, jpacked):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# Packed weights and edge-bias attention
# ---------------------------------------------------------------------------

def _packed_grads(loss_fn, w: PackedEdgeWeights, *arrays):
    """Gradients of ``loss_fn(w, *arrays)``: the packed weights' as a
    PackedEdgeWeights, then the arrays'."""
    src = [t.detach().requires_grad_() for t in w.src]
    dst = [t.detach().requires_grad_() for t in w.dst]
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    grads = torch.autograd.grad(
        loss_fn(PackedEdgeWeights(src=src, dst=dst), *ts), src + dst + ts)
    ns, nd = len(src), len(dst)
    return (PackedEdgeWeights(src=list(grads[:ns]),
                              dst=list(grads[ns: ns + nd])),
            grads[ns + nd:])


@pytest.mark.parametrize("multihead", [False, True])
def test_ell_spmm_packed_weights(setup, multihead):
    """Packed-weight SpMM: the forward equals the canonical path, and both
    packed cotangents unpack to JAX's canonical cotangent."""
    g = setup["g"]
    (se, de), (jse, jde) = setup["ell"], setup["jell"]
    n, e, e_pad = g.n_nodes, g.n_edges, g.num_edges_padded
    ed = _rand(31, (e_pad, 2) if multihead else (e_pad,))
    x = _rand(32, (n, 2, 8) if multihead else (n, 8))
    ed[e:] = 0
    w = ell_pack_weights(se, de, torch.from_numpy(ed))
    y = ell_spmm(se, de, w, torch.from_numpy(x))
    _close(y, ell_spmm(se, de, torch.from_numpy(ed), torch.from_numpy(x)))
    gw, (gx,) = _packed_grads(
        lambda w, x: (ell_spmm(se, de, w, x) ** 2).sum(), w, x)
    jw = J.ell_pack_weights(jse, jde, jnp.asarray(ed))
    jgw, jgx = jax.grad(lambda w, x: (J.ell_spmm(jse, jde, w, x) ** 2).sum(),
                        argnums=(0, 1))(jw, jnp.asarray(x))
    _close(gx, jgx, (1e-3, 1e-3))
    want = J.ell_unpack_weights(jse, jgw)
    _close(ell_unpack_weights(se, gw), want, (1e-3, 1e-3), rows=e)
    _close(ell_gather_edges(de, gw.dst), want, (1e-3, 1e-3), rows=e)


@pytest.mark.parametrize("multihead", [False, True])
def test_ell_edge_bias_attention(setup, multihead):
    g = setup["g"]
    (se, de), (jse, jde) = setup["ell"], setup["jell"]
    n = g.n_nodes
    shape = (n, 2, 8) if multihead else (n, 8)
    q, k, v = (_rand(s, shape) for s in (33, 34, 35))
    be = _rand(36, (g.num_edges_padded, 8))
    got = _value_and_grads_torch(
        lambda q, k, v, be: (ell_edge_bias_attention(de, se, q, k, v, be)
                             ** 2).sum(), q, k, v, be)
    want = _value_and_grads_jax(
        lambda q, k, v, be: (J.ell_edge_bias_attention(jde, jse, q, k, v, be)
                             ** 2).sum(), q, k, v, be)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3)
    for a, b, name in zip(got[1], want[1], "qkvb"):
        _close(a, b, (2e-3, 2e-3),
               rows=g.n_edges if name == "b" else None)


@pytest.mark.parametrize("multihead", [False, True])
def test_ell_edge_bias_attention_packed(setup, multihead):
    """Packed edge features give the canonical results, and packed
    cotangents that unpack to JAX's canonical cotangent."""
    g = setup["g"]
    (se, de), (jse, jde) = setup["ell"], setup["jell"]
    n, d, e = g.n_nodes, 8, g.n_edges
    shape = (n, 2, d) if multihead else (n, d)
    q, k, v = (_rand(s, shape) for s in (37, 38, 39))
    be = _rand(40, (g.num_edges_padded, d))
    tq, tk, tv, tbe = map(torch.from_numpy, (q, k, v, be))
    w = ell_pack_weights(se, de, tbe)
    _close(ell_edge_bias_attention(de, se, tq, tk, tv, w),
           ell_edge_bias_attention(de, se, tq, tk, tv, tbe))
    gw, (gq,) = _packed_grads(
        lambda w, q: (ell_edge_bias_attention(de, se, q, tk, tv, w)
                      ** 2).sum(), w, q)
    gq_r, gbe_r = jax.grad(
        lambda q, be: (J.ell_edge_bias_attention(jde, jse, q, k, v, be)
                       ** 2).sum(), argnums=(0, 1))(jnp.asarray(q),
                                                    jnp.asarray(be))
    _close(gq, gq_r, (1e-3, 1e-3))
    _close(ell_gather_edges(se, gw.src), gbe_r, (1e-3, 1e-3), rows=e)
    _close(ell_gather_edges(de, gw.dst), gbe_r, (1e-3, 1e-3), rows=e)


# ---------------------------------------------------------------------------
# The public ops' impl="ell" routes against the segment oracle
# ---------------------------------------------------------------------------

ROUTES = {
    "sddmm": lambda g, t, impl: sddmm(g, t["A"], t["B"], impl=impl),
    "vector_spmm": lambda g, t, impl: vector_spmm(g, t["ew"], t["A"],
                                                  impl=impl),
    "edge_softmax_src": lambda g, t, impl: edge_softmax(g, t["ew"], by="src",
                                                        impl=impl),
    "edge_softmax_dst": lambda g, t, impl: edge_softmax(g, t["ew"], by="dst",
                                                        impl=impl),
    "node_mul_edge": lambda g, t, impl: node_mul_edge(g, t["A"], t["Be"],
                                                      impl=impl),
    "attention": lambda g, t, impl: attention(g, t["A"], t["B"], t["C"],
                                              impl=impl),
    "attention_edge_bias": lambda g, t, impl: attention(
        g, t["A"], t["B"], t["C"], edge_bias=t["Be"], impl=impl),
    "gat_attention": lambda g, t, impl: gat_attention(g, t["al"], t["ar"],
                                                      t["A"], impl=impl),
}


@pytest.mark.parametrize("op", sorted(ROUTES))
def test_impl_ell_matches_the_segment_oracle(setup, op):
    g = setup["g"]
    n, e, h = g.n_nodes, g.n_edges, 2
    arrays = {"A": _rand(41, (n, h, 8)), "B": _rand(42, (n, h, 8)),
              "C": _rand(43, (n, h, 8)), "ew": _rand(44, (e, h)),
              "Be": _rand(45, (e, 8)), "al": _rand(46, (h, 8)),
              "ar": _rand(47, (h, 8))}
    outs = {}
    for impl in ("ell", "xla"):
        t = {k: torch.from_numpy(a).requires_grad_()
             for k, a in arrays.items()}
        y = ROUTES[op](g, t, impl)
        (y[:e] ** 2).sum().backward() if y.shape[0] == g.num_edges_padded \
            else (y ** 2).sum().backward()
        outs[impl] = (y.detach()[:e] if y.shape[0] == g.num_edges_padded
                      else y.detach(),
                      {k: v.grad for k, v in t.items() if v.grad is not None})
    _close(outs["ell"][0], outs["xla"][0], (1e-4, 1e-4))
    assert sorted(outs["ell"][1]) == sorted(outs["xla"][1])
    for k, gx in outs["xla"][1].items():
        _close(outs["ell"][1][k], gx, (1e-3, 1e-3))


# ---------------------------------------------------------------------------
# Packing invariants (the cases of tests/test_packing_properties.py)
# ---------------------------------------------------------------------------

def _graph_zoo(builders):
    random_graph_, from_coo_ = builders
    rng = np.random.default_rng(7)
    zoo = [random_graph_(n, e, seed=seed, power_law=pl)
           for seed, (n, e, pl) in enumerate([
               (50, 200, False), (200, 1500, True), (64, 64, False),
               (300, 4000, True), (17, 40, False)])]
    n = 40
    zoo.append(from_coo_(np.arange(1, n), np.zeros(n - 1, int), n))   # star
    zoo.append(from_coo_(np.r_[np.arange(n - 1), np.arange(n)],
                         np.r_[np.arange(1, n), np.arange(n)], n))  # chain
    zoo.append(from_coo_([0, 0, 0, 1, 1], [1, 1, 2, 2, 2], 4))     # multi
    zoo.append(from_coo_(rng.integers(0, 30, 97), rng.integers(0, 30, 97),
                         30, pad_multiple=128))                      # padded
    return zoo


@pytest.fixture(scope="module")
def zoo():
    return (_graph_zoo((random_graph, from_coo)),
            _graph_zoo((jax_random_graph, jax_from_coo)))


@pytest.mark.parametrize("gi", range(9))
@pytest.mark.parametrize("direction", ["src", "dst"])
def test_ell_pack_invariants(zoo, gi, direction):
    g, jg = zoo[0][gi], zoo[1][gi]
    eg = ell_pack(g, direction=direction)
    _assert_packing_equal(eg, jax_ell_pack(jg, direction=direction))
    n, e, e_pad = g.n_nodes, g.n_edges, g.num_edges_padded
    eids = (torch.cat([b.eid.reshape(-1) for b in eg.buckets]).numpy()
            if eg.buckets else np.empty(0, np.int64))
    expected = (np.arange(e) if direction == "src"
                else np.sort(g.csc_perm.numpy()[:e]))
    np.testing.assert_array_equal(np.sort(eids[eids < e_pad]), expected)
    # Each node owns its row (or reads the zeros row at degree 0).
    indptr = (g.indptr_r if direction == "src" else g.indptr_c).numpy()
    deg = np.diff(indptr[: n + 1])
    rows_cat = (torch.cat([b.rows for b in eg.buckets]).numpy()
                if eg.buckets else np.empty(0, np.int32))
    row_pos = eg.row_pos.numpy()
    for v in range(n):
        if deg[v] == 0:
            assert row_pos[v] == eg.total_rows
        else:
            assert rows_cat[row_pos[v]] == v
    # edge_pos inverts the packing on real edges.
    x = torch.from_numpy(np.random.default_rng(gi).normal(
        size=(e_pad,)).astype(np.float32))
    if eg.buckets:
        back = ell_gather_edges(eg, ell_scatter_edges(eg, x))
        np.testing.assert_array_equal(back.numpy()[:e], x.numpy()[:e])
    assert int(eg.edge_pos.max()) <= eg.total_slots
    # Padding slots point at the dummy node and the scratch eid together.
    for b in eg.buckets:
        assert torch.equal(b.cols == n, b.eid == e_pad)


@pytest.mark.parametrize("gi", [0, 1, 3, 7])
def test_twin_slot_roundtrip_matches_canonical(zoo, gi):
    g = zoo[0][gi]
    se, de = ell_dual(g)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(g.num_edges_padded,)).astype(np.float32))
    packed_src = ell_scatter_edges(se, x)
    via_twin = ell_cross_packed(se, de, packed_src)
    via_canon = ell_scatter_edges(de, ell_gather_edges(se, packed_src))
    for a, b, bucket in zip(via_twin, via_canon, de.buckets):
        live = bucket.eid < g.num_edges_padded
        assert torch.equal(a[live], b[live])
        assert not a[~live].any()
