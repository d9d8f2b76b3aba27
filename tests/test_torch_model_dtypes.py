"""The models' dtype policy against the JAX package (tests/test_dtypes.py's
model cases, on every path).

GAT and GraphTransformer take ``dtype=bfloat16``: f32 parameters, bf16
activations through the ops, f32 logits. Both packages load the same f32
weights (``flax_to_state_dict``) and take the same numpy features; the
port's bf16 logits must be f32 and agree

- with JAX's bf16 model per element within 2⁻⁶·|JAX| + 2e-2·max|JAX|
  (a few bf16 roundings of the activations, which the two frameworks
  place at the same ops but sum in other orders), and
- with the port's own f32 model at tests/test_dtypes.py's rtol 0.1,
  atol 0.15.

The paths: segment, ELL (``ell=``), tiles (``tiled=``, the transformer's
K4 in bf16, here its plain version) and dense blocks (``block=``). The
bf16 GAT trains on the ELL path to the reference's val_acc > 0.9. GCN,
GraphSAGE and GIN take no dtype and follow their input as flax does:
bf16 features into f32 weights compute (and return) in f32, with the
copy-sum run on whatever dtype reaches it (bf16 in GraphSAGE's and GIN's
first layer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_op_benchmark_tpu.data.synthetic import (
    planted_partition as jax_planted_partition,
)
from custom_op_benchmark_tpu.graph import block_graph as jax_block_graph
from custom_op_benchmark_tpu.graph import clique_batch as jax_clique_batch
from custom_op_benchmark_tpu.graph.tiled import tile_graph as jax_tile_graph
from custom_op_benchmark_tpu.models import (
    GAT as JaxGAT,
    GCN as JaxGCN,
    GIN as JaxGIN,
    GraphSAGE as JaxSAGE,
    GraphTransformer as JaxTransformer,
)
from custom_op_benchmark_tpu.ops import ell_dual as jax_ell_dual
from custom_op_benchmark_tpu_torch.data import planted_partition
from custom_op_benchmark_tpu_torch.graph import (
    block_graph,
    clique_batch,
    tile_graph,
)
from custom_op_benchmark_tpu_torch.models import (
    GAT,
    GCN,
    GIN,
    GraphSAGE,
    GraphTransformer,
    flax_to_state_dict,
)
from custom_op_benchmark_tpu_torch.ops import ell_dual
from custom_op_benchmark_tpu_torch.train import fit_full_graph

DATA = dict(num_classes=4, nodes_per_class=60, seed=3)
F32_TOL = dict(rtol=0.1, atol=0.15)


@pytest.fixture(scope="module")
def graphs():
    ds, jds = planted_partition(**DATA), jax_planted_partition(**DATA)
    cg, jcg = clique_batch(6, 10), jax_clique_batch(6, 10)
    rng = np.random.default_rng(7)
    return dict(
        ds=ds, g=ds.graph, jg=jds.graph, x=ds.features,
        ell=ell_dual(ds.graph), jell=jax_ell_dual(jds.graph),
        tg=tile_graph(ds.graph), jtg=jax_tile_graph(jds.graph),
        cg=cg, jcg=jcg, bg=block_graph(cg), jbg=jax_block_graph(jcg),
        cx=rng.normal(size=(cg.n_nodes, ds.features.shape[1])).astype(
            np.float32))


def _views(c, path):
    """(graph, features, port views, JAX graph, JAX views) of a path."""
    if path == "block":
        return c["cg"], c["cx"], {"block": c["bg"]}, c["jcg"], \
            {"block": c["jbg"]}
    views = {"segment": ({}, {}), "ell": ({"ell": c["ell"]},
                                          {"ell": c["jell"]}),
             "tiled": ({"tiled": c["tg"]}, {"tiled": c["jtg"]})}[path]
    return (c["g"], c["x"], views[0], c["jg"], views[1])


def _check(c, path, make_jax, make_port):
    g, x, views, jg, jviews = _views(c, path)
    jx = jnp.asarray(x)
    params = make_jax(None).init(jax.random.PRNGKey(0), jg, jx,
                                 **jviews)["params"]
    want = np.asarray(make_jax(jnp.bfloat16).apply({"params": params}, jg,
                                                   jx, **jviews))
    state = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    models = {}
    for dt in (None, torch.bfloat16):
        models[dt] = make_port(dt, x.shape[1])
        models[dt].load_state_dict(state, strict=True)
    assert all(p.dtype == torch.float32
               for p in models[torch.bfloat16].parameters())
    tx = torch.from_numpy(x)
    got = models[torch.bfloat16](g, tx, **views)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    tol = 2.0 ** -6 * np.abs(want) + 2e-2 * np.abs(want).max()
    excess = float((np.abs(got.detach().numpy() - want) - tol).max())
    assert excess <= 0, f"bf16 vs JAX's bf16 exceeds tolerance by {excess}"
    torch.testing.assert_close(got, models[None](g, tx, **views), **F32_TOL)


@pytest.mark.parametrize("path", ["segment", "ell", "block"])
def test_gat_bf16_matches_jax(graphs, path):
    _check(graphs, path,
           lambda dt: JaxGAT(hidden_dim=16, out_dim=4, num_layers=2,
                             num_heads=2, dtype=dt),
           lambda dt, in_dim: GAT(16, 4, num_layers=2, num_heads=2,
                                  dtype=dt, in_dim=in_dim))


@pytest.mark.parametrize("path", ["segment", "ell", "tiled", "block"])
def test_transformer_bf16_matches_jax(graphs, path):
    _check(graphs, path,
           lambda dt: JaxTransformer(dim=16, num_heads=2, num_layers=2,
                                     out_dim=4, dtype=dt),
           lambda dt, in_dim: GraphTransformer(16, 2, 2, out_dim=4,
                                               dtype=dt, in_dim=in_dim))


def test_bf16_gat_backward_is_finite_and_reaches_f32_params(graphs):
    c = graphs
    model = GAT(16, 4, num_layers=2, num_heads=2, dtype=torch.bfloat16,
                remat=True, in_dim=c["x"].shape[1],
                generator=torch.Generator().manual_seed(0))
    model(c["g"], torch.from_numpy(c["x"]), ell=c["ell"]).sum().backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name


def test_bf16_gat_trains_on_the_ell_path():
    """tests/test_dtypes.py's training case: 60 epochs, val_acc > 0.9."""
    ds = planted_partition(**DATA)
    _, metrics = fit_full_graph(
        GAT(16, 4, num_layers=2, num_heads=2, dtype=torch.bfloat16,
            in_dim=ds.features.shape[1]),
        ds, epochs=60, strategy="ell", device="cpu")
    assert metrics["val_acc"] > 0.9, metrics


@pytest.mark.parametrize("name", ["GCN", "GraphSAGE", "GIN"])
def test_models_without_dtype_follow_bf16_features_as_flax(graphs, name):
    c = graphs
    jcls = {"GCN": JaxGCN, "GraphSAGE": JaxSAGE, "GIN": JaxGIN}[name]
    cls = {"GCN": GCN, "GraphSAGE": GraphSAGE, "GIN": GIN}[name]
    jx = jnp.asarray(c["x"], jnp.bfloat16)
    jmodel = jcls(hidden_dim=16, out_dim=4)
    params = jmodel.init(jax.random.PRNGKey(0), c["jg"], jx,
                         ell=c["jell"])["params"]
    want = np.asarray(jmodel.apply({"params": params}, c["jg"], jx,
                                   ell=c["jell"]))
    model = cls(16, 4, in_dim=c["x"].shape[1])
    model.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    got = model(c["g"], torch.from_numpy(c["x"]).bfloat16(), ell=c["ell"])
    assert got.dtype == torch.float32 and want.dtype == np.float32
    tol = 2.0 ** -6 * np.abs(want) + 2e-2 * np.abs(want).max()
    excess = float((np.abs(got.detach().numpy() - want) - tol).max())
    assert excess <= 0, f"bf16 features vs JAX exceed tolerance by {excess}"
