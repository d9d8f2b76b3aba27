"""The port's tile kernels (plain versions) against the Pallas kernels.

The JAX package's Pallas kernels run in interpret mode on the CPU, as its
own tests run them; the port's wrappers take their plain PyTorch versions
for CPU tensors. Same numpy inputs for both, f32, rtol/atol 1e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from custom_op_benchmark_tpu.graph import from_coo as jax_from_coo
from custom_op_benchmark_tpu.graph.tiled import tile_graph as jax_tile_graph
from custom_op_benchmark_tpu.ops.pallas.attention import (
    fused_attention_rows as jax_attention,
)
from custom_op_benchmark_tpu.ops.pallas.tiled_kernels import (
    sddmm_tiles_kernel,
    spmm_col_sweep_kernel,
    spmm_row_sweep_kernel,
)
from custom_op_benchmark_tpu_torch.graph import from_coo, tile_graph
from custom_op_benchmark_tpu_torch.ops.kernels import attention as k_attn
from custom_op_benchmark_tpu_torch.ops.kernels import tiled_kernels as k_tiled

TOL = dict(rtol=1e-5, atol=1e-5)
N, TS, D = 37, 8, 16   # nodes, tile size, feature width


@pytest.fixture(scope="module")
def graphs():
    """An irregular graph, n not a multiple of the tile: row block 1 has no
    out-edges and column block 3 no in-edges (both empty), and some rows of
    non-empty blocks have no edges."""
    rng = np.random.default_rng(7)
    src = rng.choice(np.r_[0:8, 16:N], size=160)
    dst = rng.choice(np.r_[0:24, 32:N], size=160)
    jg = jax_tile_graph(jax_from_coo(src, dst, N), TS, TS)
    tg = tile_graph(from_coo(src, dst, N), TS, TS)
    assert np.diff(tg.tile_ptr.numpy())[1] == 0
    assert np.diff(tg.tile_ptr_c.numpy())[3] == 0
    return jg, tg


def _pad(x, rows):
    """Zero-pad rows to the tile view and features to the TPU lane width,
    as the JAX callers do before a Pallas kernel."""
    out = np.zeros((rows, 128), np.float32)
    out[: x.shape[0], : x.shape[1]] = x
    return jnp.asarray(out)


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_sddmm_tiles_matches_pallas(graphs):
    jg, tg = graphs
    A, B = _normal(0, N, D), _normal(1, N, D)
    want = sddmm_tiles_kernel(jg.tile_rows, jg.tile_cols, jg.mask,
                              _pad(A, tg.n_rows_padded),
                              _pad(B, tg.n_cols_padded))
    got = k_tiled.sddmm_tiles(tg.tile_rows, tg.tile_cols, tg.mask,
                              torch.from_numpy(A), torch.from_numpy(B))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_spmm_row_sweep_matches_pallas(graphs):
    jg, tg = graphs
    vals, x = _normal(2, tg.num_tiles, TS, TS), _normal(3, N, D)
    want = spmm_row_sweep_kernel(jg.tile_ptr, jg.tile_cols,
                                 jnp.asarray(vals), _pad(x, tg.n_cols_padded),
                                 jg.max_tiles_per_row)
    got = k_tiled.spmm_row_sweep(tg.tile_ptr, tg.tile_cols,
                                 torch.from_numpy(vals), torch.from_numpy(x))
    assert got.shape == (tg.n_rows_padded, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :D], **TOL)
    assert not got[TS:2 * TS].any()   # the empty row block writes zeros


def test_spmm_col_sweep_matches_pallas(graphs):
    jg, tg = graphs
    vals, y = _normal(4, tg.num_tiles, TS, TS), _normal(5, N, D)
    want = spmm_col_sweep_kernel(jg.tile_ptr_c, jg.tile_perm_c, jg.tile_rows,
                                 jnp.asarray(vals), _pad(y, tg.n_rows_padded),
                                 jg.max_tiles_per_col)
    got = k_tiled.spmm_col_sweep(tg.tile_ptr_c, tg.tile_perm_c, tg.tile_rows,
                                 torch.from_numpy(vals), torch.from_numpy(y),
                                 N)
    assert got.shape == (N, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:N, :D], **TOL)
    assert not got[3 * TS:4 * TS].any()   # the empty column block


@pytest.mark.parametrize("scale, d", [
    pytest.param(0.25, D, id="0.25"),
    pytest.param(3.0, D, id="3.0"),
    pytest.param(128 ** -0.5, 128, id="d128"),
])
def test_fused_attention_rows_matches_pallas(graphs, scale, d):
    jg, tg = graphs
    q, k, v = _normal(6, N, d), _normal(7, N, d), _normal(8, N, d)
    want = jax_attention(jg.tile_ptr, jg.tile_cols, jg.mask,
                         _pad(q, tg.n_rows_padded), _pad(k, tg.n_cols_padded),
                         _pad(v, tg.n_cols_padded), jg.max_tiles_per_row,
                         scale)
    got = k_attn.fused_attention_rows(
        tg.tile_ptr, tg.tile_cols, tg.mask, torch.from_numpy(q),
        torch.from_numpy(k), torch.from_numpy(v), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:N, :d], **TOL)
    no_edges = np.diff(tg.tile_ptr.numpy()).repeat(TS)[:N] == 0
    assert not got[torch.from_numpy(no_edges)].any()


def test_heads_read_in_place(graphs):
    """(n, H, d) inputs give each head what the single-head call gives."""
    _, tg = graphs
    h = 3
    A, B = torch.from_numpy(_normal(9, N, h, D)), torch.from_numpy(
        _normal(10, N, h, D))
    s = k_tiled.sddmm_tiles(tg.tile_rows, tg.tile_cols, tg.mask, A, B)
    y = k_tiled.spmm_row_sweep(tg.tile_ptr, tg.tile_cols, s, B, N)
    x = k_tiled.spmm_col_sweep(tg.tile_ptr_c, tg.tile_perm_c, tg.tile_rows,
                               s, A, N)
    o = k_attn.fused_attention_rows(tg.tile_ptr, tg.tile_cols, tg.mask,
                                    A, B, B, 0.5)
    assert s.shape == (h, tg.num_tiles, TS, TS)
    for i in range(h):
        a, b = A[:, i].contiguous(), B[:, i].contiguous()
        si = k_tiled.sddmm_tiles(tg.tile_rows, tg.tile_cols, tg.mask, a, b)
        np.testing.assert_allclose(s[i].numpy(), si.numpy(), **TOL)
        np.testing.assert_allclose(
            y[:, i].numpy(),
            k_tiled.spmm_row_sweep(tg.tile_ptr, tg.tile_cols, si, b,
                                   N).numpy(), **TOL)
        np.testing.assert_allclose(
            x[:, i].numpy(),
            k_tiled.spmm_col_sweep(tg.tile_ptr_c, tg.tile_perm_c,
                                   tg.tile_rows, si, a, N).numpy(), **TOL)
        np.testing.assert_allclose(
            o[:, i].numpy(),
            k_attn.fused_attention_rows(tg.tile_ptr, tg.tile_cols, tg.mask,
                                        a, b, b, 0.5).numpy(), **TOL)


def test_cpu_tensors_take_the_plain_versions(graphs):
    """A CPU call runs the plain version and launches nothing."""
    _, tg = graphs
    before = (k_tiled.sddmm_tiles.launches, k_tiled.spmm_row_sweep.launches,
              k_tiled.spmm_col_sweep.launches,
              k_attn.fused_attention_rows.launches)
    a = torch.from_numpy(_normal(11, N, D))
    k_tiled.sddmm_tiles(tg.tile_rows, tg.tile_cols, tg.mask, a, a)
    k_attn.fused_attention_rows(tg.tile_ptr, tg.tile_cols, tg.mask, a, a, a,
                                1.0)
    after = (k_tiled.sddmm_tiles.launches, k_tiled.spmm_row_sweep.launches,
             k_tiled.spmm_col_sweep.launches,
             k_attn.fused_attention_rows.launches)
    assert after == before


@pytest.mark.parametrize("device", ["meta", "mixed"])
def test_wrappers_raise_off_cpu_without_a_kernel(graphs, device):
    """Only CPU tensors take the plain version; a device with no kernel, or
    tensors on several devices, raise."""
    _, tg = graphs
    a = torch.zeros(N, D, device="meta")
    b = a if device == "meta" else torch.zeros(N, D)
    if device == "meta":
        tg = tg.to("meta")
    with pytest.raises(ValueError):
        k_tiled.sddmm_tiles(tg.tile_rows, tg.tile_cols, tg.mask, a, b)
    with pytest.raises(ValueError):
        k_attn.fused_attention_rows(tg.tile_ptr, tg.tile_cols, tg.mask,
                                    a, b, b, 1.0)


def _attention_args(d, heads=None, tiles=2, rows=300):
    """CPU tensors shaped as the attention kernel takes them."""
    shape = (rows, d) if heads is None else (rows, heads, d)
    x = torch.zeros(shape)
    return (torch.tensor([0, 1, 2, 2], dtype=torch.int32),
            torch.zeros(tiles, dtype=torch.int32),
            torch.zeros((tiles, 128, 128), dtype=torch.bool), x, x, x)


@pytest.mark.parametrize("d, heads", [(128, None), (40, 3), (1, None),
                                      (256, 2)])
def test_attention_kernel_checks_accept_widths_to_256(d, heads):
    """The checks the CUDA kernel's wrapper makes take every head width
    from 1 to 256 (the kernel was built for 64 only before)."""
    n_q, h, dd, nrb = k_attn.check_kernel_args(*_attention_args(d, heads))
    assert (n_q, h, dd, nrb) == (300, heads or 1, d, 3)


@pytest.mark.parametrize("d, heads", [(257, None), (300, 2), (1024, None)])
def test_attention_kernel_checks_accept_wide_heads(d, heads):
    """K4 and S5 take heads wider than 256 (the reference pads any width);
    they get the cluster form of the tensor-core kernel, never the plain
    version."""
    args = _attention_args(d, heads)
    want = (300, heads or 1, d, 3)
    assert k_attn.check_kernel_args(*args) == want
    assert k_attn.check_kernel_args(*args, s5=True) == want
    assert k_attn.kernel_route(d)[0] == "wide"


def test_attention_kernel_checks_take_bf16_for_k4_only():
    ptr, cols, mask, q, k, v = _attention_args(64)
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    assert k_attn.check_kernel_args(ptr, cols, mask, q, k, v)[2] == 64
    with pytest.raises(ValueError):
        k_attn.check_kernel_args(ptr, cols, mask, q, k, v, s5=True)
    with pytest.raises(ValueError, match="one dtype"):
        k_attn.check_kernel_args(ptr, cols, mask, q, k.float(), v)


@pytest.mark.parametrize("bad", ["d0", "float64", "rows", "tile", "cols"])
def test_attention_kernel_checks_refuse(bad):
    ptr, cols, mask, q, k, v = _attention_args(0 if bad == "d0" else 64)
    if bad == "float64":
        q = q.double()
    elif bad == "rows":
        q = torch.zeros(3 * 128 + 1, 64)
    elif bad == "tile":
        mask = torch.zeros((2, 64, 64), dtype=torch.bool)
    elif bad == "cols":
        cols = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        k_attn.check_kernel_args(ptr, cols, mask, q, k if bad != "rows"
                                 else q, v if bad != "rows" else q)
