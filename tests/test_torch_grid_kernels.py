"""The grid-regime kernels S1, S2, S4 and S5 (plain versions) against the
Pallas kernels of scripts/exp_grid_dma.py and scripts/exp_grid_bisect.py.

The JAX side runs on the CPU: S1 with ``interpret=True`` once the name
``pltpu.TPUMemorySpace``, which jax 0.9 renamed ``MemorySpace``, is aliased
here; S4 and S5 under ``pltpu.force_tpu_interpret_mode()``. S2 runs in
neither interpreter (exp_grid_dma.py:152 slices a loaded value with
``pl.ds``), so the port's S2 is held against JAX's K2 on the same inputs,
the check the script itself makes (exp_grid_dma.py:246-252). Same numpy
inputs for both packages, on the tile-aligned 32×32 grid in 128×128 tiles,
f32, rtol/atol 1e-5; in bf16, one bf16 rounding. A numpy model of S1/S2's
persistent schedule (csrc/grid_dma.cu) runs its mbarrier ring under random
interleavings of the producer warp, the copies and the consumers.

The one launch path of ops/kernels, ``_build.call``, on a fake library:
the entry point by dtype, the device and stream last, the op-scope range
inside the caller's span, the error naming the entry point, the launch
counted under its dtype and not on failure; and every wrapper, taken past
its CPU branch, launching once through it.
"""

import contextlib
import ctypes
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch.profiler import ProfilerActivity, profile

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
    random_graph,
    reorder_graph,
    tile_aligned_order,
    tile_graph,
)
from custom_op_benchmark_tpu_torch.ops import ell_dual  # noqa: E402
from custom_op_benchmark_tpu_torch.ops.kernels import _build  # noqa: E402
from custom_op_benchmark_tpu_torch.ops.kernels import attention as k_attn  # noqa: E402
from custom_op_benchmark_tpu_torch.ops.kernels import ell_gat as k_gat  # noqa: E402
from custom_op_benchmark_tpu_torch.ops.kernels import gather_sum as k_gather  # noqa: E402
from custom_op_benchmark_tpu_torch.ops.kernels import grid_dma as k_dma  # noqa: E402
from custom_op_benchmark_tpu_torch.ops.kernels import (  # noqa: E402
    tiled_kernels as k_tiled,
)
from custom_op_benchmark_tpu_torch.utils import spans  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
SIDE, D = 32, 16
# bf16 port vs bf16 JAX: both sum in f32 and round once to bf16, so they
# differ by one bf16 rounding: |port − jax| ≤ 2⁻⁷·|jax| + 1e-4.
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-4
# csrc/grid_dma.cu's ring: RS_STAGES stages, a tile in TILE / RS_COLS chunks.
STAGES, CHUNKS = 3, 2


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
    """S5's well-posed inputs (``k_attn.well_posed_s5``: the comparison
    does not depend on summation order) as numpy arrays."""
    *arrays, scale = k_attn.well_posed_s5(tg, d, seed=11)
    return (*(a.numpy() for a in arrays), scale)


def test_well_posed_s5_inputs(grids):
    """The properties S5's comparisons without ``exp`` rest on: the even
    rows of every tile live and the odd rows masked out; every score exact
    in f32; a column block's scores within 1/4 of each other; each
    block's largest score at least 1.75 above the block before."""
    _, tg = grids
    tgt = tg.transpose()
    n, d = tgt.n_nodes, 40
    mask, q, k, v, scale = k_attn.well_posed_s5(tgt, d, seed=11)
    assert mask.shape == (tgt.num_tiles, 128, 128)
    assert mask[:, ::2].all() and not mask[:, 1::2].any()
    assert q.shape == k.shape == v.shape == (n, d)
    assert not v[:, 2:].any() and set(v[:, :2].unique().tolist()) == {-1, 1}
    s = (q @ k.T) * scale
    torch.testing.assert_close(s.double(), (q.double() @ k.double().T) * scale,
                               rtol=0, atol=0)
    blocks = s.reshape(n, n // 128, 128)
    top, bottom = blocks.amax(-1), blocks.amin(-1)
    assert (top - bottom).max() <= 0.25
    assert (top[:, 1:] - top[:, :-1]).min() >= 1.75


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


@pytest.mark.parametrize("use_exp, use_mask", [
    (True, True), (True, False), (False, True), (False, False)])
def test_attn_variant_wide_head_matches_pallas(grids, use_exp, use_mask):
    """S5 at d = 300, the cluster form's width on the card: JAX gets q, k
    and v zero-padded to 384 features, as its callers pad to the lane
    width; the port gets d = 300 and its output is compared unpadded."""
    jt, tg = grids
    jtt, tgt = jt.transpose(), tg.transpose()
    d, wide = 300, 384
    mask, q, k, v, scale = _well_posed(tgt, d)

    def padded(x, rows):
        out = np.zeros((rows, wide), np.float32)
        out[: x.shape[0], :d] = x
        return jnp.asarray(out)

    with pltpu.force_tpu_interpret_mode():
        want = jax_bisect.attn_variant(
            jtt.tile_ptr, jtt.tile_cols, jnp.asarray(mask),
            padded(q, jtt.n_rows_padded), padded(k, jtt.n_cols_padded),
            padded(v, jtt.n_cols_padded), jtt.max_tiles_per_row, scale,
            use_exp=use_exp, use_mask=use_mask)
    got = k_attn.attn_variant(tgt.tile_ptr, tgt.tile_cols,
                              torch.from_numpy(mask),
                              *(torch.from_numpy(a) for a in (q, k, v)),
                              scale, use_exp=use_exp, use_mask=use_mask)
    assert got.shape == (tg.n_nodes, d)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want)[: tg.n_nodes, :d], **TOL)
    assert not np.asarray(want)[:, d:].any()
    assert np.abs(got.numpy()).max() > 0.1     # not all rows read 0


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


def _bf16_close(got: torch.Tensor, want) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= BF16_RTOL * np.abs(want) + BF16_ATOL).all(), diff.max()


def test_spmm_row_sweep_dma_bf16_matches_pallas(grids):
    jt, tg = grids
    vals, x = _tile_vals(tg, 21), _normal(22, tg.n_nodes, D)
    jcols, jvals = jax_dma.pad_layout(jt, jnp.asarray(vals))
    want = jax_dma.spmm_row_sweep_dma(
        jcols, jvals.astype(jnp.bfloat16),
        _pad(x, jt.n_cols_padded).astype(jnp.bfloat16), interpret=True)
    assert want.dtype == jnp.bfloat16
    cols, vp = k_dma.pad_layout(tg, torch.from_numpy(vals))
    got = k_dma.spmm_row_sweep_dma(cols, vp.bfloat16(),
                                   torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16 and got.shape == (tg.n_rows_padded, D)
    _bf16_close(got, want)


def test_spmm_row_sweep_dma_v2_bf16_matches_k2(grids):
    """JAX's K2 in bf16 rounds its sum to bf16 after every tile
    (ops/pallas/tiled_kernels.py:103-105); the S2 it stands in for sums in
    f32 and rounds once (exp_grid_dma.py:149-156), as the port does. So
    JAX's K2 runs on the bf16 values widened to f32, rounded once."""
    jt, tg = grids
    vals, x = _tile_vals(tg, 23), _normal(24, tg.n_nodes, D)
    v16 = jnp.asarray(vals).astype(jnp.bfloat16)
    x16 = _pad(x, jt.n_cols_padded).astype(jnp.bfloat16)
    want = spmm_row_sweep_kernel(
        jt.tile_ptr, jt.tile_cols, v16.astype(jnp.float32),
        x16.astype(jnp.float32), jt.max_tiles_per_row).astype(jnp.bfloat16)
    got = k_dma.spmm_row_sweep_dma_v2(tg.tile_ptr, tg.tile_cols,
                                      torch.from_numpy(vals).bfloat16(),
                                      torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    _bf16_close(got, want)


def test_bf16_wrappers_run_plain_on_cpu(grids):
    """On CPU tensors the bf16 S1, S2 and S5 (both switches on) run their
    plain versions, launch nothing and return bf16; S5 in bf16 is K4's
    plain version."""
    _, tg = grids
    wrappers = (k_dma.spmm_row_sweep_dma, k_dma.spmm_row_sweep_dma_v2,
                k_attn.attn_variant)
    before = [(w.launches, w.launches_bf16) for w in wrappers]
    x = torch.from_numpy(_normal(25, tg.n_nodes, D)).bfloat16()
    vals = torch.from_numpy(_tile_vals(tg, 26)).bfloat16()
    cols, vp = k_dma.pad_layout(tg, vals)
    y1 = k_dma.spmm_row_sweep_dma(cols, vp, x)
    y2 = k_dma.spmm_row_sweep_dma_v2(tg.tile_ptr, tg.tile_cols, vals, x)
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)   # padding adds 0
    tgt = tg.transpose()
    args = (tgt.tile_ptr, tgt.tile_cols, tgt.mask, x, x, x, D ** -0.5)
    y5 = k_attn.attn_variant(*args)
    assert all(y.dtype == torch.bfloat16 for y in (y1, y2, y5))
    assert torch.equal(y5, k_attn.fused_attention_rows_plain(*args))
    assert [(w.launches, w.launches_bf16) for w in wrappers] == before


class _FakeLibrary:
    """A kernel library whose every entry point records its name and
    arguments and returns ``status``."""

    def __init__(self, status):
        self.status, self.calls = status, []

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return self.status
        return entry


def _fake_library(monkeypatch, status=0):
    """``_build.call`` launches on a fake library, device 7, stream "s"."""
    lib = _FakeLibrary(status)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "device_stream", lambda t: (7, "s"))
    return lib


def _counter():
    def fn():
        pass

    fn.launches = fn.launches_bf16 = 0
    return fn


@pytest.mark.parametrize("status", [0, 700], ids=["ok", "failed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_call_launches_the_dtypes_entry_in_a_span_and_counts_it(
        monkeypatch, dtype, status):
    """``_build.call`` launches ``<name>_f32`` or ``<name>_bf16`` by the
    tensor's dtype with the arguments as given, then the device and the
    stream; inside an op-scope profiler range named after the entry point,
    within the caller's span; counts one launch under the dtype, and none
    where the launch failed, which raises naming the entry point."""
    lib = _fake_library(monkeypatch, status)
    fn = _counter()
    entry = "kern_bf16" if dtype == torch.bfloat16 else "kern_f32"
    arg = ctypes.c_void_p(16)
    failed = pytest.raises(RuntimeError, match=rf"^{entry}: .*{status}")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("ell.kern.fwd"), (failed if status
                                          else contextlib.nullcontext()):
            _build.call(fn, "kern", torch.zeros(2, dtype=dtype), 3, arg, None)
    assert lib.calls == [(entry, (3, arg, None, 7, "s"))]
    n = 0 if status else 1
    assert (fn.launches, fn.launches_bf16) == (
        (0, n) if dtype == torch.bfloat16 else (n, 0))
    ev = {e.name: e for e in prof.events()}
    k, s = ev[entry].time_range, ev["ell.kern.fwd"].time_range
    assert not ev[entry].is_user_annotation
    assert s.start <= k.start <= k.end <= s.end


def test_launches_are_counted_by_dtype(monkeypatch):
    """A launch counts under its dtype only, so a float32 row's launches
    hold no bfloat16 ones."""
    _fake_library(monkeypatch)
    fn = _counter()
    _build.call(fn, "kern", torch.zeros(1))
    _build.call(fn, "kern", torch.zeros(1, dtype=torch.bfloat16))
    _build.call(fn, "kern", torch.zeros(1, dtype=torch.bfloat16))
    assert (fn.launches, fn.launches_bf16) == (1, 2)


def _wrapper_launches(tg, dtype):
    """{kernel: (wrapper whose counter counts, entry point, one call)}:
    every wrapper of ops/kernels on CPU tensors of ``dtype``."""
    x = torch.from_numpy(_normal(40, tg.n_nodes, D)).to(dtype)
    vals = torch.from_numpy(_tile_vals(tg, 41)).to(dtype)
    tgt = tg.transpose()
    att = (tgt.tile_ptr, tgt.tile_cols, tgt.mask, x, x, x, D ** -0.5)
    se, de = ell_dual(random_graph(60, 400, seed=2))
    h, d = 2, 8
    z = torch.from_numpy(_normal(42, de.n_nodes, h, d)).to(dtype)
    a = torch.from_numpy(_normal(43, h, d))
    el = torch.zeros((de.n_nodes, h))
    alpha = torch.zeros((de.total_slots, h))
    ad = torch.zeros((de.total_slots, 2 * h))
    ptr = torch.tensor([0, 3, 3, 7], dtype=torch.int32)
    cols = torch.randint(0, tg.n_nodes, (5, 4), dtype=torch.int32)
    sfx = "bf16" if dtype == torch.bfloat16 else "f32"
    cases = {
        "K1": (k_tiled.sddmm_tiles, "sddmm_tiles", lambda: k_tiled.sddmm_tiles(
            tg.tile_rows, tg.tile_cols, tg.mask, x, x)),
        "K2": (k_tiled.spmm_row_sweep, "spmm_row_sweep",
               lambda: k_tiled.spmm_row_sweep(tg.tile_ptr, tg.tile_cols,
                                              vals, x)),
        "K3": (k_tiled.spmm_col_sweep, "spmm_col_sweep",
               lambda: k_tiled.spmm_col_sweep(tg.tile_ptr_c, tg.tile_perm_c,
                                              tg.tile_rows, vals, x)),
        "K4": (k_attn.fused_attention_rows, "fused_attention_rows",
               lambda: k_attn.fused_attention_rows(*att)),
        # S5 in bf16 is K4's bf16 launch, counted on attn_variant.
        "S5": (k_attn.attn_variant, "fused_attention_rows"
               if dtype == torch.bfloat16 else "attn_variant",
               lambda: k_attn.attn_variant(*att)),
        "S1": (k_dma.spmm_row_sweep_dma, "spmm_row_sweep_dma",
               lambda: k_dma.spmm_row_sweep_dma(
                   *k_dma.pad_layout(tg, vals), x)),
        "S2": (k_dma.spmm_row_sweep_dma_v2, "spmm_row_sweep_dma_v2",
               lambda: k_dma.spmm_row_sweep_dma_v2(tg.tile_ptr, tg.tile_cols,
                                                   vals, x)),
        "S3": (k_gather.gather_sum, "gather_sum",
               lambda: k_gather.gather_sum(cols, x)),
        "S3 CSR": (k_gather.csr_sum, "csr_sum",
                   lambda: k_gather.csr_sum(ptr, x)),
        "G1": (k_gat.gat_forward, "ell_gat_fwd",
               lambda: k_gat.gat_forward(de, a, a, z, 0.2)),
        "G2": (k_gat.gat_backward_dst, "ell_gat_bwd_dst",
               lambda: k_gat.gat_backward_dst(de, z, z, alpha, el, el, 0.2)),
        "G3": (k_gat.gat_backward_src, "ell_gat_bwd_src",
               lambda: k_gat.gat_backward_src(se, a, a, z, z, ad, el)),
    }
    if dtype == torch.float32:
        cases["S4"] = (k_tiled.spmm_dotonly, "spmm_dotonly",
                       lambda: k_tiled.spmm_dotonly(tg.tile_ptr,
                                                    tg.tile_cols, x))
    return {k: (fn, f"{entry}_{sfx}", run)
            for k, (fn, entry, run) in cases.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_every_wrapper_launches_through_call(grids, monkeypatch, dtype):
    """Each wrapper of ops/kernels, taken past its CPU branch, makes exactly
    one launch, of its entry point for the dtype, through ``_build.call``
    and counts it there under the dtype."""
    _, tg = grids
    for module in (k_tiled, k_attn, k_dma, k_gather, k_gat):
        monkeypatch.setattr(module, "on_cpu", lambda *t: False,
                            raising=False)
    for name, (fn, entry, run) in _wrapper_launches(tg, dtype).items():
        for attr in [a for a in vars(fn) if a.startswith("launches")]:
            monkeypatch.setattr(fn, attr, getattr(fn, attr))
        lib = _fake_library(monkeypatch)
        before = (fn.launches, getattr(fn, "launches_bf16", 0))
        run()
        assert [c[0] for c in lib.calls] == [entry], name
        assert lib.calls[0][1][-2:] == (7, "s"), name
        bf16 = dtype == torch.bfloat16
        assert (fn.launches, getattr(fn, "launches_bf16", 0)) == (
            before[0] + (not bf16), before[1] + bf16), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["no tiles", "no x rows"])
def test_dma_with_nothing_to_multiply_writes_zeros(grids, case, dtype):
    """S1 and S2 where no tile reaches the products: no tile at all over the
    grid's row blocks (S1 with max_tpr = 0, S2 with an empty tile list), or
    the grid's tiles with an x of no rows. Every output row is zero, as in
    K2's plain version."""
    _, tg = grids
    nrb = tg.num_row_blocks
    vals = torch.from_numpy(_tile_vals(tg, 27)).to(dtype)
    x = torch.from_numpy(_normal(28, tg.n_nodes, D)).to(dtype)
    if case == "no tiles":
        ptr = torch.zeros(nrb + 1, dtype=torch.int32)
        cols = torch.zeros(0, dtype=torch.int32)
        vals = vals[:0]
        s1 = (torch.zeros((nrb, 0), dtype=torch.int32),
              vals.reshape(nrb, 0, 128, 128), x)
    else:
        ptr, cols, x = tg.tile_ptr, tg.tile_cols, x[:0]
        s1 = (*k_dma.pad_layout(tg, vals), x)
    y1 = k_dma.spmm_row_sweep_dma(*s1)
    y2 = k_dma.spmm_row_sweep_dma_v2(ptr, cols, vals, x)
    want = k_tiled.spmm_row_sweep_plain(ptr, cols, vals, x)
    for y in (y1, y2):
        assert y.dtype == dtype and y.shape == (nrb * 128, D)
        assert torch.equal(y, torch.zeros_like(y)) and torch.equal(y, want)


@pytest.mark.parametrize("use_exp, use_mask", [
    (True, False), (False, True), (False, False)])
def test_attn_variant_bf16_takes_only_exp_and_mask(grids, use_exp, use_mask):
    _, tg = grids
    x = torch.zeros(tg.n_nodes, D, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        k_attn.attn_variant(tg.tile_ptr, tg.tile_cols, tg.mask, x, x, x, 1.0,
                            use_exp=use_exp, use_mask=use_mask)


# ---------------------------------------------------------------------------
# S1/S2's persistent schedule (csrc/grid_dma.cu), in numpy
# ---------------------------------------------------------------------------

def persistent_schedule(counts, slices, blocks):
    """The chunks each persistent block takes, in order, as (item, tile
    slot, chunk, stage, pass parity): block b takes the items (row block
    w // slices, feature slice w % slices) w = b, b + blocks, ...; chunk q
    of its sequence sits in stage q % STAGES, pass q // STAGES."""
    out = []
    for b in range(blocks):
        seq, q = [], 0
        for w in range(b, len(counts) * slices, blocks):
            for c in range(counts[w // slices] * CHUNKS):
                seq.append((w, c // CHUNKS, c % CHUNKS, q % STAGES,
                            (q // STAGES) & 1))
                q += 1
        out.append(seq)
    return out


def run_ring(seq, rng):
    """One block's ring under a random interleaving of the producer warp
    (waits on a stage's empty barrier with parity ^ 1, issues the copies),
    the copies (land in any order; the full barrier completes) and the
    consumers (wait on the full barrier with the pass parity, read,
    release). A wait on parity P passes once the barrier's completed phases
    are odd for P = 0, even for P = 1, as ``mbarrier.try_wait.parity``
    does. Asserts that no copy overwrites a stage before it is released,
    that each consumer wait passes only on its own chunk, and that nothing
    deadlocks; returns the chunks in the order the consumers took them."""
    full, empty = [0] * STAGES, [0] * STAGES   # completed phases
    held = [None] * STAGES                      # the chunk a stage holds
    flying, taken, issued = [], [], 0
    while len(taken) < len(seq):
        moves = []
        if issued < len(seq):
            s, par = seq[issued][3:]
            if empty[s] % 2 != par ^ 1:
                moves.append("issue")
        if flying:
            moves.append("land")
        s, par = seq[len(taken)][3:]
        if full[s] % 2 != par:
            moves.append("take")
        assert moves, "the ring deadlocked"
        move = moves[rng.integers(len(moves))]
        if move == "issue":
            s = seq[issued][3]
            assert held[s] is None and all(seq[q][3] != s for q in flying)
            flying.append(issued)
            issued += 1
        elif move == "land":
            q = flying.pop(rng.integers(len(flying)))
            held[seq[q][3]] = q
            full[seq[q][3]] += 1
        else:
            q = len(taken)
            assert held[s] == q, (q, held[s])
            taken.append(seq[q])
            held[s] = None
            empty[s] += 1
    return taken


def test_ring_wraps_across_row_blocks():
    """One block over row blocks of 2, 1, 0 and 3 tiles: passes of the ring
    hold chunks of two row blocks, the empty one takes no chunk, and the
    ring still hands each chunk to the consumers in order."""
    (seq,) = persistent_schedule([2, 1, 0, 3], 1, 1)
    passes = [{w for w, *_ in seq[k:k + STAGES]}
              for k in range(0, len(seq), STAGES)]
    assert any(len(p) > 1 for p in passes)
    assert 2 not in {w for w, *_ in seq}
    assert [q[3:] for q in seq[:7]] == [(0, 0), (1, 0), (2, 0), (0, 1),
                                        (1, 1), (2, 1), (0, 0)]
    rng = np.random.default_rng(3)
    for _ in range(200):
        assert run_ring(seq, rng) == seq


def test_ring_with_a_wrong_parity_deadlocks_or_misreads():
    """The model catches the fault it is there for: consumers that wait on
    the phase of the item (flipping per row block) instead of the ring's
    pass either read a stage too early or deadlock."""
    (seq,) = persistent_schedule([2, 1, 3], 1, 1)
    wrong = [(w, s, c, st, w & 1) for w, s, c, st, _ in seq]
    rng = np.random.default_rng(5)
    caught = 0
    for _ in range(50):
        try:
            run_ring(wrong, rng)
        except AssertionError:
            caught += 1
    assert caught == 50


def _irregular_counts():
    """Tiles per row block of a 300-node graph whose row block 1 is empty."""
    from custom_op_benchmark_tpu_torch.graph import from_coo

    rng = np.random.default_rng(0)
    src = rng.choice(np.r_[0:128, 256:300], size=4000)
    dst = rng.choice(np.r_[0:256], size=4000)
    return tile_graph(from_coo(src, dst, 300), 128, 128)


@pytest.mark.parametrize("graph, d, dn, blocks, padded", [
    ("grid", 16, 64, 3, False),        # the ring wraps inside row blocks
    ("grid", 16, 64, 3, True),         # S1: every row block max_tpr slots
    ("grid", 200, 128, 5, False),      # two feature slices an item
    ("irregular", 40, 64, 5, False),   # 3 items: two blocks get none
    ("irregular", 300, 128, 4, True),  # empty row block, 3 slices
])
def test_persistent_schedule_sums_each_row_block_once_in_k2_order(
        grids, graph, d, dn, blocks, padded):
    tg = grids[1] if graph == "grid" else _irregular_counts()
    ptr = tg.tile_ptr.numpy().astype(np.int64)
    nrb, mt = tg.num_row_blocks, tg.max_tiles_per_row
    counts = [mt] * nrb if padded else list(np.diff(ptr))
    slices = -(-d // dn)
    sched = persistent_schedule(counts, slices, blocks)
    assert sum(map(len, sched)) == sum(counts) * CHUNKS * slices
    if blocks > nrb * slices:
        assert not sched[-1]            # a block with no item
    rng = np.random.default_rng(7)
    for seq in sched:
        for _ in range(20):
            assert run_ring(seq, rng) == seq
    assert max(counts) * CHUNKS > STAGES    # the ring wraps inside an item

    # The sums, in the kernel's order: each item's chunks, then its store.
    vals = _tile_vals(tg, 31)
    if padded:
        _, vp = k_dma.pad_layout(tg, torch.from_numpy(vals))
        tv = vp.reshape(-1, 128, 128).numpy()
        _cols = k_dma.pad_layout(tg, torch.from_numpy(vals))[0].reshape(-1)
        tcols, lo = _cols.numpy(), [i * mt for i in range(nrb)]
    else:
        tv, tcols, lo = vals, tg.tile_cols.numpy(), ptr[:-1]
    x = _normal(32, tg.n_nodes, d)
    xz = np.zeros((-(-tg.n_nodes // 128) * 128 + 128, d), np.float32)
    xz[: tg.n_nodes] = x
    y = np.full((nrb * 128, d), np.nan, np.float32)
    stores = np.zeros((nrb, slices), int)
    for b, seq in enumerate(sched):
        items = {}
        for w, slot, c, *_ in seq:
            items.setdefault(w, []).append((slot, c))
        for w in range(b, nrb * slices, blocks):
            rb, f0 = w // slices, (w % slices) * dn
            order = items.get(w, [])
            assert order == [(s, c) for s in range(counts[rb])
                             for c in range(CHUNKS)]   # K2's order
            acc = np.zeros((128, min(dn, d - f0)), np.float32)
            for slot, c in order:
                t = lo[rb] + slot
                r0 = int(tcols[t]) * 128 + c * 64
                acc += tv[t][:, c * 64:(c + 1) * 64] @ xz[r0:r0 + 64,
                                                          f0:f0 + dn]
            y[rb * 128:(rb + 1) * 128, f0:f0 + dn] = acc
            stores[rb, w % slices] += 1
    assert (stores == 1).all()          # every row block once, per slice
    for rb in np.flatnonzero(np.diff(ptr) == 0):
        assert not y[rb * 128:(rb + 1) * 128].any()   # empty: zeros
    want = k_tiled.spmm_row_sweep_plain(tg.tile_ptr, tg.tile_cols,
                                        torch.from_numpy(vals),
                                        torch.from_numpy(x))
    np.testing.assert_allclose(y, want.numpy(), rtol=1e-4, atol=1e-4)

