"""bf16 through the port's op family, against f32 and the JAX package.

The three op-level cases of tests/test_dtypes.py: the op family takes
bf16 and returns bf16 (segment oracle, and the tile strategy, whose
kernels K1–K3 run their plain versions on the CPU: f32 arithmetic on the
widened inputs, one rounding at the end); bf16 agrees with f32 at the
reference's rtol = atol = 2e-2; the dense-block ops take bf16. The
model-level cases are in tests/test_torch_model_dtypes.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_op_benchmark_tpu import ops as jops
from custom_op_benchmark_tpu.graph import block_graph as jax_block_graph
from custom_op_benchmark_tpu.graph import clique_batch as jax_clique_batch
from custom_op_benchmark_tpu_torch import ops as tops
from custom_op_benchmark_tpu_torch.graph import block_graph, clique_batch

LOOSE = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module")
def setup():
    g = clique_batch(4, 10)
    rng = np.random.default_rng(0)
    A = rng.normal(size=(g.n_nodes, 16)).astype(np.float32)
    B = rng.normal(size=(g.n_nodes, 16)).astype(np.float32)
    return g, A, B


def _family(g, A, B, impl):
    s = tops.sddmm(g, A, B, impl=impl)
    a = tops.edge_softmax(g, s, by="src", impl=impl)
    return s, a, tops.vector_spmm(g, a, B, impl=impl)


@pytest.mark.parametrize("impl", ["auto", "tiled"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_op_family_dtypes(setup, dtype, impl):
    g, A, B = setup
    tA, tB = torch.from_numpy(A).to(dtype), torch.from_numpy(B).to(dtype)
    s, a, y = _family(g, tA, tB, impl)
    assert s.dtype == a.dtype == y.dtype == dtype
    assert y.shape == (g.n_nodes, 16)
    assert torch.isfinite(y.float()).all()
    if dtype == torch.bfloat16:
        s32, a32, y32 = _family(g, torch.from_numpy(A), torch.from_numpy(B),
                                impl)
        e = g.n_edges
        for lo, hi in ((s[:e], s32[:e]), (a[:e], a32[:e]), (y, y32)):
            np.testing.assert_allclose(lo.float().numpy(), hi.numpy(),
                                       rtol=0.05, atol=0.1)


@pytest.mark.parametrize("impl", ["auto", "tiled", "dense_block"])
def test_bf16_matches_f32_loosely(setup, impl):
    g, A, _ = setup
    ones = torch.ones(g.n_edges)
    y32 = tops.vector_spmm(g, ones, torch.from_numpy(A), impl=impl)
    y16 = tops.vector_spmm(g, ones.bfloat16(),
                           torch.from_numpy(A).bfloat16(), impl=impl)
    assert y16.dtype == torch.bfloat16
    np.testing.assert_allclose(y16.float().numpy(), y32.numpy(), **LOOSE)
    want = jops.vector_spmm(jax_clique_batch(4, 10),
                            jnp.ones((g.n_edges,), jnp.bfloat16),
                            jnp.asarray(A, jnp.bfloat16))
    np.testing.assert_allclose(y16.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **LOOSE)


def test_block_ops_bf16():
    """bf16 in, bf16 out, finite, and within bf16 rounding of JAX's bf16
    result."""
    g, jg = clique_batch(4, 10), jax_clique_batch(4, 10)
    bg, jbg = block_graph(g), jax_block_graph(jg)
    rng = np.random.default_rng(0)
    q = rng.normal(size=(g.n_nodes, 16)).astype(np.float32)
    ed = rng.uniform(size=(g.n_edges,)).astype(np.float32)
    tq = torch.from_numpy(q).bfloat16()
    ted = torch.from_numpy(ed).bfloat16()
    y = tops.block_spmm(bg, bg.scatter_edges(ted), bg.scatter_nodes(tq))
    assert y.dtype == torch.bfloat16
    jy = jops.block_spmm(jbg, jbg.scatter_edges(jnp.asarray(ed, jnp.bfloat16)),
                         jbg.scatter_nodes(jnp.asarray(q, jnp.bfloat16)))
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)), **LOOSE)
    out = tops.block_attention(bg, *(bg.scatter_nodes(tq),) * 3)
    assert out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()


@pytest.mark.parametrize("kernel", ["sddmm_tiles", "spmm_row_sweep",
                                    "spmm_col_sweep", "fused_attention_rows"])
def test_tile_kernels_plain_bf16_rounds_once(kernel):
    """K1–K4's plain versions on bf16 inputs are their f32 results on the
    widened inputs, rounded to bf16 once."""
    from custom_op_benchmark_tpu_torch.graph import random_graph, tile_graph
    from custom_op_benchmark_tpu_torch.ops.kernels import attention as ka
    from custom_op_benchmark_tpu_torch.ops.kernels import tiled_kernels as kt

    g = random_graph(300, 2400, seed=4)
    tg = tile_graph(g, 128, 128)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(g.n_nodes, 2, 24)).astype(
        np.float32)).bfloat16()
    vals = torch.from_numpy(rng.normal(size=(2, tg.num_tiles, 128, 128))
                            .astype(np.float32)).bfloat16()
    args = {
        "sddmm_tiles": (kt.sddmm_tiles, (tg.tile_rows, tg.tile_cols, tg.mask,
                                         x, x)),
        "spmm_row_sweep": (kt.spmm_row_sweep, (tg.tile_ptr, tg.tile_cols,
                                               vals, x)),
        "spmm_col_sweep": (kt.spmm_col_sweep, (tg.tile_ptr_c, tg.tile_perm_c,
                                               tg.tile_rows, vals, x)),
        "fused_attention_rows": (ka.fused_attention_rows,
                                 (tg.tile_ptr, tg.tile_cols, tg.mask, x, x,
                                  x, 0.2)),
    }
    fn, a = args[kernel]
    got = fn(*a)
    want = fn(*(t.float() if torch.is_tensor(t) and t.is_floating_point()
                else t for t in a))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())
