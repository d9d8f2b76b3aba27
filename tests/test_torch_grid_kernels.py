"""The grid-regime kernels S1, S2, S4 and S5 (plain versions) against the
Pallas kernels of scripts/exp_grid_dma.py and scripts/exp_grid_bisect.py.

The JAX side runs on the CPU: S1 with ``interpret=True`` once the name
``pltpu.TPUMemorySpace``, which jax 0.9 renamed ``MemorySpace``, is aliased
here; S4 and S5 under ``pltpu.force_tpu_interpret_mode()``. S2 runs in
neither interpreter (exp_grid_dma.py:152 slices a loaded value with
``pl.ds``), so the port's S2 is held against JAX's K2 on the same inputs,
the check the script itself makes (exp_grid_dma.py:246-252). Same numpy
inputs for both packages, on the tile-aligned 32×32 grid in 128×128 tiles,
f32, rtol/atol 1e-5.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

if not hasattr(pltpu, "TPUMemorySpace"):
    pltpu.TPUMemorySpace = pltpu.MemorySpace
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))

import exp_grid_bisect as jax_bisect  # noqa: E402
import exp_grid_dma as jax_dma  # noqa: E402

from custom_op_benchmark_tpu.graph import grid_graph as jax_grid_graph  # noqa: E402
from custom_op_benchmark_tpu.graph.reorder import (  # noqa: E402
    reorder_graph as jax_reorder_graph,
    tile_aligned_order as jax_tile_aligned_order,
)
from custom_op_benchmark_tpu.graph.tiled import (  # noqa: E402
    tile_graph as jax_tile_graph,
)
from custom_op_benchmark_tpu.ops.pallas.tiled_kernels import (  # noqa: E402
    spmm_row_sweep_kernel,
)
from custom_op_benchmark_tpu_torch.graph import (  # noqa: E402
    grid_graph,
    reorder_graph,
    tile_aligned_order,
    tile_graph,
)
from custom_op_benchmark_tpu_torch.ops.kernels import attention as k_attn  # noqa: E402
from custom_op_benchmark_tpu_torch.ops.kernels import grid_dma as k_dma  # noqa: E402
from custom_op_benchmark_tpu_torch.ops.kernels import (  # noqa: E402
    tiled_kernels as k_tiled,
)

TOL = dict(rtol=1e-5, atol=1e-5)
SIDE, D = 32, 16


@pytest.fixture(scope="module")
def grids():
    """The tile-aligned 32×32 grid (n = 1024: 8 row blocks of 128, up to 3
    tiles each) in both packages."""
    jg = jax_grid_graph(SIDE, SIDE)
    jg2, _ = jax_reorder_graph(jg, jax_tile_aligned_order(jg, block=128))
    g = grid_graph(SIDE, SIDE)
    g2, _ = reorder_graph(g, tile_aligned_order(g, block=128))
    jt, tg = jax_tile_graph(jg2, 128, 128), tile_graph(g2, 128, 128)
    np.testing.assert_array_equal(np.asarray(jt.tile_ptr), tg.tile_ptr)
    np.testing.assert_array_equal(np.asarray(jt.mask), tg.mask)
    return jt, tg


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _pad(x, rows):
    out = np.zeros((rows,) + x.shape[1:], np.float32)
    out[: x.shape[0]] = x
    return jnp.asarray(out)


def _tile_vals(tg, seed):
    return np.where(tg.mask.numpy(), _normal(seed, tg.num_tiles, 128, 128),
                    0.0).astype(np.float32)


def test_pad_layout_matches_the_script(grids):
    jt, tg = grids
    vals = _tile_vals(tg, 0)
    jcols, jvals = jax_dma.pad_layout(jt, jnp.asarray(vals))
    cols, vp = k_dma.pad_layout(tg, torch.from_numpy(vals))
    assert cols.dtype == torch.int32
    np.testing.assert_array_equal(cols.numpy(), np.asarray(jcols))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(jvals))


def test_pad_layout_empty_row_block():
    """An empty row block pads with column 0 and zero tiles."""
    from custom_op_benchmark_tpu_torch.graph import from_coo

    src, dst = np.r_[0:10, 300:310], np.r_[5:15, 140:150]
    tg = tile_graph(from_coo(src, dst, 384), 128, 128)
    vals = torch.ones(tg.num_tiles, 128, 128)
    cols, vp = k_dma.pad_layout(tg, vals)
    assert tg.max_tiles_per_row == 1 and cols[1].tolist() == [0]
    assert not vp[1].any() and vp[0].all()


def test_spmm_row_sweep_dma_matches_pallas(grids):
    jt, tg = grids
    vals, x = _tile_vals(tg, 1), _normal(2, tg.n_nodes, D)
    jcols, jvals = jax_dma.pad_layout(jt, jnp.asarray(vals))
    want = jax_dma.spmm_row_sweep_dma(jcols, jvals,
                                      _pad(x, jt.n_cols_padded),
                                      interpret=True)
    cols, vp = k_dma.pad_layout(tg, torch.from_numpy(vals))
    got = k_dma.spmm_row_sweep_dma(cols, vp, torch.from_numpy(x))
    assert got.shape == (tg.n_rows_padded, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_spmm_row_sweep_dma_v2_matches_k2(grids):
    jt, tg = grids
    vals, x = _tile_vals(tg, 3), _normal(4, tg.n_nodes, D)
    want = spmm_row_sweep_kernel(jt.tile_ptr, jt.tile_cols,
                                 jnp.asarray(vals), _pad(x, jt.n_cols_padded),
                                 jt.max_tiles_per_row)
    got = k_dma.spmm_row_sweep_dma_v2(tg.tile_ptr, tg.tile_cols,
                                      torch.from_numpy(vals),
                                      torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_spmm_dotonly_matches_pallas(grids):
    jt, tg = grids
    x = _normal(5, tg.n_nodes, D)
    with pltpu.force_tpu_interpret_mode():
        want = jax_bisect.spmm_dotonly(jt.tile_ptr, jt.tile_cols,
                                       jt.num_tiles,
                                       _pad(x, jt.n_cols_padded),
                                       jt.max_tiles_per_row)
    got = k_tiled.spmm_dotonly(tg.tile_ptr, tg.tile_cols, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _well_posed(tg, d):
    """Inputs on which S5 without ``exp`` is a well-posed comparison.

    Without ``exp`` the recurrence is ``l = l·(m_prev − m) + Σ(s − m)``, a
    sum whose terms change sign, and a masked score (−1e30) multiplied by
    a jump of the running max overflows, so on general inputs rounding
    decides the sign of ``l`` and whether a row reads 0. These inputs avoid
    that, and so the comparison does not depend on summation order:

    - each live row is a whole tile row (the even rows of each tile); the
      odd rows are masked out everywhere, keep m = −1e9, m_prev − m = 0,
      and read 0;
    - q is 1 in features 0 and 1; k holds 16 × the key's column block in
      feature 0 and ±1 in feature 1; v two entries of ±1; scale 1/8. Every
      score is exact in f32, a tile's scores spread by 1/4, and a row's
      maxima rise by at least 2 from tile to tile, so |l·(m_prev − m)|
      outgrows |Σ(s − m)| and the sign of l is robust.
    """
    rng = np.random.default_rng(11)
    n = tg.n_nodes
    q = np.zeros((n, d), np.float32)
    q[:, :2] = 1.0
    k = np.zeros((n, d), np.float32)
    k[:, 0] = (np.arange(n) // 128) * 16
    k[:, 1] = rng.choice([-1.0, 1.0], size=n)
    v = np.zeros((n, d), np.float32)
    v[:, :2] = rng.choice([-1.0, 1.0], size=(n, 2))
    mask = np.zeros((tg.num_tiles, 128, 128), bool)
    mask[:, ::2, :] = True
    return mask, q, k, v, 0.125


@pytest.mark.parametrize("use_exp, use_mask", [
    (True, True), (True, False), (False, True), (False, False)])
def test_attn_variant_matches_pallas(grids, use_exp, use_mask):
    jt, tg = grids
    jtt, tgt = jt.transpose(), tg.transpose()
    if use_exp:
        mask = tgt.mask.numpy()
        q, k, v = (_normal(6 + i, tg.n_nodes, D) for i in range(3))
        scale = D ** -0.5
    else:
        mask, q, k, v, scale = _well_posed(tgt, D)
    with pltpu.force_tpu_interpret_mode():
        want = jax_bisect.attn_variant(
            jtt.tile_ptr, jtt.tile_cols, jnp.asarray(mask),
            _pad(q, jtt.n_rows_padded), _pad(k, jtt.n_cols_padded),
            _pad(v, jtt.n_cols_padded), jtt.max_tiles_per_row, scale,
            use_exp=use_exp, use_mask=use_mask)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = k_attn.attn_variant(tgt.tile_ptr, tgt.tile_cols,
                              torch.from_numpy(mask), *t, scale,
                              use_exp=use_exp, use_mask=use_mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[: tg.n_nodes],
                               **TOL)
    assert np.abs(got.numpy()).max() > 0.1     # not all rows read 0
    if not use_exp and use_mask:
        assert not got.numpy()[1::2].any()     # the masked-out rows


def test_attn_variant_with_both_switches_on_is_k4(grids):
    _, tg = grids
    tgt = tg.transpose()
    q, k, v = (torch.from_numpy(_normal(9 + i, tg.n_nodes, 3, D))
               for i in range(3))
    args = (tgt.tile_ptr, tgt.tile_cols, tgt.mask, q, k, v, 0.3)
    np.testing.assert_allclose(
        k_attn.attn_variant(*args).numpy(),
        k_attn.fused_attention_rows(*args).numpy(), **TOL)


def test_cpu_tensors_launch_nothing(grids):
    _, tg = grids
    wrappers = (k_dma.spmm_row_sweep_dma, k_dma.spmm_row_sweep_dma_v2,
                k_tiled.spmm_dotonly, k_attn.attn_variant)
    before = [w.launches for w in wrappers]
    x = torch.from_numpy(_normal(12, tg.n_nodes, D))
    vals = torch.from_numpy(_tile_vals(tg, 13))
    cols, vp = k_dma.pad_layout(tg, vals)
    k_dma.spmm_row_sweep_dma(cols, vp, x)
    k_dma.spmm_row_sweep_dma_v2(tg.tile_ptr, tg.tile_cols, vals, x)
    k_tiled.spmm_dotonly(tg.tile_ptr, tg.tile_cols, x)
    k_attn.attn_variant(tg.tile_ptr, tg.tile_cols, tg.mask, x, x, x, 1.0,
                        use_exp=False)
    assert [w.launches for w in wrappers] == before


@pytest.mark.parametrize("device", ["meta", "mixed"])
def test_grid_wrappers_raise_off_cpu_without_a_kernel(grids, device):
    _, tg = grids
    x = torch.zeros(tg.n_nodes, D, device="meta")
    y = x if device == "meta" else torch.zeros(tg.n_nodes, D)
    tgm = tg.to("meta") if device == "meta" else tg
    vals = torch.zeros(tg.num_tiles, 128, 128, device="meta")
    with pytest.raises(ValueError):
        k_dma.spmm_row_sweep_dma_v2(tgm.tile_ptr, tgm.tile_cols, vals, y)
    with pytest.raises(ValueError):
        k_tiled.spmm_dotonly(tgm.tile_ptr, tgm.tile_cols, y if device ==
                             "meta" else x)
    with pytest.raises(ValueError):
        k_attn.attn_variant(tgm.tile_ptr, tgm.tile_cols, tgm.mask, x, y, y,
                            1.0)
