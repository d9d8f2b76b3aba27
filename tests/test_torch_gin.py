"""The port's GIN against the JAX package on its three paths.

Segment (``gspmm`` copy_lhs/sum), ``ell=`` (``ell_copy_spmm``, which runs
S3's plain version on the CPU) and ``block=`` (``block_copy_spmm``, whole
stack). The JAX model's parameters (``eps``, ``mlp1``, ``mlp2``) load
through ``flax_to_state_dict``; logits and loss are held to JAX's at
rtol = atol = 1e-4, every gradient at 1e-3. Graphs: cliques of different
sizes (the block layout has padded slots) and a random multigraph with
isolated nodes (segment and ELL).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_op_benchmark_tpu.graph import block_graph as jax_block_graph
from custom_op_benchmark_tpu.graph import from_coo as jax_from_coo
from custom_op_benchmark_tpu.models import GIN as JaxGIN
from custom_op_benchmark_tpu.ops import ell_dual as jax_ell_dual
from custom_op_benchmark_tpu_torch.graph import block_graph, from_coo
from custom_op_benchmark_tpu_torch.models import GIN, flax_to_state_dict
from custom_op_benchmark_tpu_torch.ops import ell_dual

LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-3)
IN, HIDDEN, OUT = 12, 16, 5


def _cliques():
    src, dst, base = [], [], 0
    for s in (6, 2, 9, 4, 9, 1):
        ids = np.arange(base, base + s)
        src.append(np.repeat(ids, s))
        dst.append(np.tile(ids, s))
        base += s
    return np.concatenate(src), np.concatenate(dst), base


def _random():
    rng = np.random.default_rng(1)
    n = 90      # nodes 80..89 have no edges
    return rng.integers(0, 80, 500), rng.integers(0, 80, 500), n


GRAPHS = {"cliques": _cliques, "random": _random}


def _views(name, path):
    src, dst, n = GRAPHS[name]()
    g, jg = from_coo(src, dst, n), jax_from_coo(src, dst, n)
    if path == "block":
        return g, jg, {"block": block_graph(g)}, {"block": jax_block_graph(jg)}
    if path == "ell":
        return g, jg, {"ell": ell_dual(g)}, {"ell": jax_ell_dual(jg)}
    return g, jg, {}, {}


@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("graph, path", [
    ("cliques", "segment"), ("cliques", "ell"), ("cliques", "block"),
    ("random", "segment"), ("random", "ell")])
def test_gin_matches_jax(graph, path, layers):
    g, jg, views, jviews = _views(graph, path)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(g.n_nodes, IN)).astype(np.float32)
    w = rng.normal(size=(g.n_nodes, OUT)).astype(np.float32)
    jmodel = JaxGIN(hidden_dim=HIDDEN, out_dim=OUT, num_layers=layers)
    params = jmodel.init(jax.random.PRNGKey(0), jg, jnp.asarray(x))["params"]
    prng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * prng.normal(size=np.shape(p)).astype(
            np.float32), params)

    def jloss(p):
        y = jmodel.apply({"params": p}, jg, jnp.asarray(x), **jviews)
        return (y * jnp.asarray(w)).sum(), y

    (jl, jy), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    model = GIN(HIDDEN, OUT, layers, in_dim=IN)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    y = model(g, torch.from_numpy(x), **views)
    loss = (y * torch.from_numpy(w)).sum()
    loss.backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               **LOGITS_TOL)
    np.testing.assert_allclose(loss.item(), float(jl), **LOGITS_TOL)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    assert all(got[k].shape == want[k].shape for k in want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_gin_starts_as_flax_does():
    model = GIN(HIDDEN, OUT, 2, in_dim=IN,
                generator=torch.Generator().manual_seed(0))
    assert all(layer.eps.item() == 0.0 for layer in model.layers)
    assert all(layer.mlp1.bias.abs().max().item() == 0.0
               for layer in model.layers)
    assert [tuple(layer.mlp2.weight.shape) for layer in model.layers] == [
        (HIDDEN, HIDDEN), (OUT, OUT)]
