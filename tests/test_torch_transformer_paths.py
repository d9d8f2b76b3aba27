"""The port's GraphTransformer on its segment and block paths, with
``dropout_rate`` and ``remat``, against the JAX package.

The graph is a batch of cliques of different sizes (3 to 11 nodes), so
the dense-block layout has padded slots. The JAX model's parameters load
through ``flax_to_state_dict``; both models take the same numpy inputs,
and the port's logits and loss (rtol = atol = 1e-4) and every parameter's
gradient (1e-3) are held to JAX's on:

- the segment path, with and without edge features;
- ``tiled=`` with edge features, which both take to the segment path;
- ``block=`` per layer (``block_whole_stack=False``) and whole-stack.

``remat=True`` equals ``remat=False`` bit for bit on the CPU, forward and
gradients, also with dropout in training mode (the recompute draws the same
mask). Dropout is off in eval mode; in training mode it keeps a share of
about 1 − p of the values, each scaled by 1/(1 − p).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_op_benchmark_tpu.graph import block_graph as jax_block_graph
from custom_op_benchmark_tpu.graph import from_coo as jax_from_coo
from custom_op_benchmark_tpu.graph.tiled import tile_graph as jax_tile_graph
from custom_op_benchmark_tpu.models import GraphTransformer as JaxTransformer
from custom_op_benchmark_tpu.train.loop import (
    masked_cross_entropy as jax_masked_ce,
)
from custom_op_benchmark_tpu_torch.graph import block_graph, from_coo, tile_graph
from custom_op_benchmark_tpu_torch.models import (
    GraphTransformer,
    flax_to_state_dict,
)
from custom_op_benchmark_tpu_torch.models.transformer import (
    GraphTransformerLayer,
)
from custom_op_benchmark_tpu_torch.train import masked_cross_entropy

LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-3)
DIM, HEADS, LAYERS, OUT = 16, 2, 2, 4
SIZES = (5, 11, 3, 8, 11, 7, 4)


def mixed_cliques():
    """Disjoint cliques of SIZES nodes with self-loops, as (src, dst, n)."""
    src, dst, base = [], [], 0
    for s in SIZES:
        ids = np.arange(base, base + s)
        src.append(np.repeat(ids, s))
        dst.append(np.tile(ids, s))
        base += s
    return np.concatenate(src), np.concatenate(dst), base


@pytest.fixture(scope="module")
def graphs():
    src, dst, n = mixed_cliques()
    g, jg = from_coo(src, dst, n), jax_from_coo(src, dst, n)
    bg, jbg = block_graph(g), jax_block_graph(jg)
    assert bg.node_mask.sum() < bg.node_mask.numel()   # padded slots exist
    rng = np.random.default_rng(0)
    return dict(
        g=g, jg=jg, bg=bg, jbg=jbg, tg=tile_graph(g, 16, 16),
        jtg=jax_tile_graph(jg, 16, 16),
        x=rng.normal(size=(n, 12)).astype(np.float32),
        ef=rng.normal(size=(g.num_edges_padded, DIM // HEADS)).astype(
            np.float32),
        labels=rng.integers(0, OUT, size=n), mask=rng.random(n) < 0.7)


def _perturbed(params, seed):
    """Perturb zero biases and unit scales, so every leaf's conversion
    shows."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.normal(size=p.shape).astype(
            np.float32), params)


def _jax_and_port(c, whole_stack=True):
    jmodel = JaxTransformer(dim=DIM, num_heads=HEADS, num_layers=LAYERS,
                            out_dim=OUT, block_whole_stack=whole_stack)
    params = jmodel.init(jax.random.PRNGKey(1), c["jg"],
                         jnp.asarray(c["x"]))["params"]
    params = _perturbed(params, 2)
    model = GraphTransformer(DIM, HEADS, LAYERS, out_dim=OUT,
                             in_dim=c["x"].shape[1],
                             block_whole_stack=whole_stack)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return jmodel, params, model


def _compare(c, views, jviews, edge_feat=False, whole_stack=True):
    jmodel, params, model = _jax_and_port(c, whole_stack)
    jx = jnp.asarray(c["x"])
    jef = (jnp.asarray(c["ef"]),) if edge_feat else ()
    ef = (torch.from_numpy(c["ef"]),) if edge_feat else ()
    labels, mask = c["labels"], c["mask"]

    def jloss(p):
        logits = jmodel.apply({"params": p}, c["jg"], jx, *jef, **jviews)
        return jax_masked_ce(logits, jnp.asarray(labels),
                             jnp.asarray(mask)), logits

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    logits = model(c["g"], torch.from_numpy(c["x"]), *ef, **views)
    loss = masked_cross_entropy(logits, torch.from_numpy(labels),
                                torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **LOGITS_TOL)
    np.testing.assert_allclose(loss.item(), float(jl), **LOGITS_TOL)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("edge_feat", [False, True])
def test_segment_path_matches_jax(graphs, edge_feat):
    _compare(graphs, {}, {}, edge_feat=edge_feat)


def test_tiled_with_edge_features_takes_the_segment_path(graphs):
    c = graphs
    _compare(c, {"tiled": c["tg"]}, {"tiled": c["jtg"]}, edge_feat=True)


@pytest.mark.parametrize("whole_stack", [False, True])
def test_block_path_matches_jax(graphs, whole_stack):
    c = graphs
    _compare(c, {"block": c["bg"]}, {"block": c["jbg"]},
             whole_stack=whole_stack)


def test_block_whole_stack_equals_per_layer_and_segment(graphs):
    """The three layouts are one function: 1e-5 on these inputs."""
    c = graphs
    model = GraphTransformer(DIM, HEADS, LAYERS, out_dim=OUT, in_dim=12,
                             generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(c["x"])
    whole = model(c["g"], x, block=c["bg"])
    model.block_whole_stack = False
    per_layer = model(c["g"], x, block=c["bg"])
    segment = model(c["g"], x)
    torch.testing.assert_close(whole, per_layer, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(whole, segment, rtol=1e-5, atol=1e-5)


def _grads(model, c, views, seed=None):
    if seed is not None:
        torch.manual_seed(seed)
    model.zero_grad(set_to_none=True)
    x = torch.from_numpy(c["x"])
    ef = torch.from_numpy(c["ef"]) if "ef" in views else None
    kw = {k: v for k, v in views.items() if k != "ef"}
    y = model(c["g"], x, ef, **kw)
    (y.sin() * y).sum().backward()
    return y.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("path", ["segment", "edge_feat", "tiled", "block"])
@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_remat_is_bit_for_bit(graphs, path, dropout):
    c = graphs
    views = {"segment": {}, "edge_feat": {"ef": True},
             "tiled": {"tiled": c["tg"]}, "block": {"block": c["bg"]}}[path]
    plain = GraphTransformer(DIM, HEADS, LAYERS, out_dim=OUT, in_dim=12,
                             dropout_rate=dropout,
                             generator=torch.Generator().manual_seed(3))
    remat = GraphTransformer(DIM, HEADS, LAYERS, out_dim=OUT, in_dim=12,
                             dropout_rate=dropout, remat=True)
    remat.load_state_dict(plain.state_dict())
    plain.train(dropout > 0)
    remat.train(dropout > 0)
    y0, g0 = _grads(plain, c, views, seed=7)
    y1, g1 = _grads(remat, c, views, seed=7)
    assert torch.equal(y0, y1)
    assert g0.keys() == g1.keys()
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_dropout_is_off_in_eval_mode(graphs):
    c = graphs
    with_dropout = GraphTransformer(DIM, HEADS, LAYERS, out_dim=OUT,
                                    in_dim=12, dropout_rate=0.5,
                                    generator=torch.Generator().manual_seed(4))
    without = GraphTransformer(DIM, HEADS, LAYERS, out_dim=OUT, in_dim=12)
    without.load_state_dict(with_dropout.state_dict())
    with_dropout.eval()
    x = torch.from_numpy(c["x"])
    assert torch.equal(with_dropout(c["g"], x), without(c["g"], x))
    with_dropout.train()
    assert not torch.equal(with_dropout(c["g"], x), without(c["g"], x))


@pytest.mark.parametrize("where", ["attention", "mlp"])
def test_dropout_keeps_one_minus_p_scaled_by_its_inverse(where):
    """A layer whose attention (or MLP) outputs ones and whose other branch
    outputs zeros: layer(x) − x is that branch's dropout of ones. Kept
    share within 0.02 of 1 − p over 40,000 values (about 8 standard
    deviations), every kept value 1/(1 − p) to 1e-6."""
    p, n, dim = 0.3, 2500, 16
    layer = GraphTransformerLayer(dim, 2, 8, 32, dropout_rate=p)
    with torch.no_grad():
        for prm in layer.parameters():
            prm.zero_()
        (layer.attn.Wo.bias if where == "attention"
         else layer.mlp2.bias).fill_(1.0)
    src = dst = np.arange(n)
    g = from_coo(src, dst, n)
    x = torch.zeros(n, dim)
    torch.manual_seed(0)
    layer.train()
    out = layer(g, x)
    kept = out != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 0.02
    torch.testing.assert_close(out[kept], torch.full_like(out[kept],
                                                          1 / (1 - p)),
                               rtol=1e-6, atol=1e-6)
    layer.eval()
    assert torch.equal(layer(g, x), torch.ones(n, dim))


def test_dtype_waits_for_the_dtype_policy():
    with pytest.raises(NotImplementedError, match="ROADMAP M9"):
        GraphTransformer(DIM, HEADS, 1, dtype=torch.bfloat16)
