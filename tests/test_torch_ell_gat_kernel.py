"""The GAT attention's ELL sweeps (ops/kernels/ell_gat.py, csrc/ell_gat.cu).

On the CPU (the tier-1 run):

- the maps the sweeps move per-slot values through: ``table_flat`` places
  each slot of a packing's GatherTable in the flat slot order that
  ``twin_slot`` and ``edge_pos`` index, and ``table_twin`` is ``twin_slot``
  read in table order, on both width ladders;
- a torch mirror of the kernels' dataflow (α and dpre written at the dst
  table slots' flat places, read back by the src table through
  ``table_twin``; row sums by table row; zero rows) against the plain op's
  forward and cotangents; a wrong map reads the NaN the mirror leaves in
  the places no slot writes;
- CPU tensors take the plain path: no library, the counters unchanged;
- how a call spreads its rows (``lane_mode``) as a function of the shape and
  the arrays' alignment, and the whole-row sums' layout: the features a
  lane holds and the tasks a row takes, each feature once, a pair of
  features in one head;
- the source's constants (with those of S3's row engine, csrc/ell_table.cuh)
  agree with the wrappers', and it has no atomic.

On the card (marker ``chip``, skipped without a CUDA device; run with
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_ell_gat_kernel.py``): the kernels against the plain torch
path on the same CUDA tensors, forward and the three cotangents, in f32
and bf16, at (h, d) = (4, 128), (1, 40), (4, 32), (2, 128) and (2, 33)
(one feature a lane), on a graph whose hub rows are longer than PIECE in
both packings, with nodes that have no in-edges, no out-edges or neither,
and pad slots; two runs equal bit for bit; the launch counts of a 3-layer
GAT step; and no gathered ``(R, D, h, d)`` tile in the op's peak memory.
The whole-row path (d % 4 != 0, or arrays off 16-byte alignment) at (3,
250) with and without the dst term, (2, 33), (4, 300) (two tasks a row)
and a (4, 128) view two elements off, f32 and bf16, against the plain
path and bit for bit against the one-float chunked sums it replaces, each
call counted on ``.launches_whole_row``; more than ROW_HEADS heads keep
the chunked sums.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from custom_op_benchmark_tpu_torch.graph import from_coo, random_graph
from custom_op_benchmark_tpu_torch.graph.ell import MAX_BUCKETS, PIECE
from custom_op_benchmark_tpu_torch.models.gat import GAT
from custom_op_benchmark_tpu_torch.ops import ell as ell_ops
from custom_op_benchmark_tpu_torch.ops.ell import (
    DENOM_FLOOR,
    MASK_VALUE,
    ell_dual,
    ell_gat_attention,
)
from custom_op_benchmark_tpu_torch.ops.kernels import _build
from custom_op_benchmark_tpu_torch.ops.kernels import ell_gat as kg

SLOPE = 0.2
SHAPES = [(4, 128), (1, 40), (4, 32), (2, 128), (2, 33)]
PROFILES = [None, "train"]
SWEEPS = (kg.gat_forward, kg.gat_backward_dst, kg.gat_backward_src)


def _graph(seed: int, n: int = 600, e: int = 5000, hub: int = 300,
           device="cpu"):
    """A random multigraph on n nodes: node 0 a hub with more than PIECE
    in-edges and out-edges; ten nodes with out-edges only, ten with
    in-edges only, ten with none; the ladders' buckets pad rows and slots."""
    assert hub > PIECE
    rng = np.random.default_rng(seed)
    body = n - 30
    fan = np.arange(1, hub + 1)
    src = np.concatenate([rng.integers(0, body, e), fan,
                          np.zeros(hub, np.int64), np.arange(body, body + 10),
                          rng.integers(0, body, 10)])
    dst = np.concatenate([rng.integers(0, body, e), np.zeros(hub, np.int64),
                          fan, rng.integers(0, body, 10),
                          np.arange(body + 10, body + 20)])
    return from_coo(src, dst, n, device=device)


def _inputs(seed: int, n: int, h: int, d: int, dtype=torch.float32,
            device="cpu"):
    """z, a_l, a_r, dy from numpy, the attention vectors scaled so that the
    scores spread over a few units."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        a = (rng.normal(size=shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    return (t(n, h, d), t(h, d, scale=d ** -0.5), t(h, d, scale=d ** -0.5),
            t(n, h, d))


def _plain(de, se, a_l, a_r, z, dy):
    out, alphas, signs = ell_ops._gat_fwd_plain(de, a_l, a_r, z, SLOPE)
    return (out,) + ell_ops._gat_bwd_plain(de, se, a_l, a_r, z, alphas,
                                           signs, dy, SLOPE)


def _flat(ell, field: str) -> torch.Tensor:
    return torch.cat([getattr(b, field).reshape(-1) for b in ell.buckets])


# ---------------------------------------------------------------------------
# CPU: the maps and the mirror of the dataflow
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", PROFILES)
def test_table_flat_places_every_table_slot(profile):
    for ell in ell_dual(_graph(1), profile=profile):
        t = ell.gather_table
        flat = ell.table_flat.long()
        assert ell.table_flat.dtype == torch.int32
        assert flat.shape == t.cols.shape
        assert torch.equal(_flat(ell, "cols")[flat], t.cols)
        assert flat.unique().numel() == flat.numel()
        # Every real edge's slot is a table slot: the slots left out are
        # the pad rows'.
        real = ell.edge_pos[: ell.n_edges].long()
        assert torch.isin(real, flat).all()


@pytest.mark.parametrize("profile", PROFILES)
def test_table_twin_is_twin_slot_in_table_order(profile):
    se, de = ell_dual(_graph(2), profile=profile)
    for me, twin in ((se, de), (de, se)):
        t = me.gather_table
        tw = me.table_twin.long()
        valid = t.cols < me.n_nodes
        eid_me = _flat(me, "eid")[me.table_flat.long()]
        assert torch.equal(_flat(twin, "eid")[tw[valid]], eid_me[valid])
        assert (tw[~valid] == twin.total_slots).all()
        assert (~valid).any()        # the graph has pad slots in real rows


def test_table_twin_needs_twin_slot():
    se, _ = ell_dual(_graph(3))
    bare = dataclasses.replace(se, twin_slot=None)
    with pytest.raises(ValueError, match="twin_slot"):
        bare.table_twin


def _table_rows(ell):
    """(table row, column) of every slot of the packing's GatherTable."""
    t = ell.gather_table
    rows = [torch.arange(r0, r0 + r).repeat_interleave(w)
            for _, w, r0, r in t.bucket_rows()]
    return torch.cat(rows), t.cols.long()


def _mirror(de, se, a_l, a_r, z, dy):
    """The kernels' dataflow in torch (f32): per table slot of the dst
    packing the scores and the masked softmax over its table row, α at the
    slot's flat place, out summed into each row's node; pass 1's dα, dpre
    and der by table row; pass 2 over the src table reading α and dpre
    through table_twin. Places no slot writes hold NaN."""
    n, h, d = z.shape
    el = torch.einsum("nhd,hd->nh", z, a_l)
    er = torch.einsum("nhd,hd->nh", z, a_r)
    t = de.gather_table
    row, col = _table_rows(de)
    ok = col < n
    row, col = row[ok], col[ok]
    node = t.nodes.long()[row]
    n_rows = t.nodes.shape[0]
    pre = el[col] + er[node]
    s = torch.where(pre > 0, pre, SLOPE * pre)
    m = torch.full((n_rows, h), MASK_VALUE).scatter_reduce(
        0, row[:, None].expand(-1, h), s, "amax")
    e = torch.exp(s - m[row])
    den = torch.zeros(n_rows, h).index_add(0, row, e).clamp(min=DENOM_FLOOR)
    flat = de.table_flat.long()[ok]
    alpha = torch.full((de.total_slots, h), float("nan"))
    alpha[flat] = e / den[row]
    a = alpha[flat]
    out = torch.zeros(n, h, d).index_add(0, node, a[..., None] * z[col])
    dal = (dy[node] * z[col]).sum(-1)
    agg = torch.zeros(n_rows, h).index_add(0, row, a * dal)
    ds = a * (dal - agg[row])
    dpre = torch.where(pre > 0, ds, SLOPE * ds)
    ad = torch.full((de.total_slots, 2 * h), float("nan"))
    ad[flat, :h], ad[flat, h:] = a, dpre
    der = torch.zeros(n, h).index_add(0, node, dpre)
    tt = se.gather_table
    row_t, col_t = _table_rows(se)
    ok_t = col_t < n
    node_t = tt.nodes.long()[row_t[ok_t]]
    tw = se.table_twin.long()[ok_t]
    acc = torch.zeros(n, h, d).index_add(
        0, node_t, ad[tw, :h, None] * dy[col_t[ok_t]])
    d_el = torch.zeros(n, h).index_add(0, node_t, ad[tw, h:])
    dz = der[..., None] * a_r + (acc + d_el[..., None] * a_l)
    return (out, torch.einsum("nh,nhd->hd", d_el, z),
            torch.einsum("nh,nhd->hd", der, z), dz)


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("h, d", [(4, 16), (1, 40), (2, 33)])
def test_mirror_of_the_sweeps_matches_the_plain_op(profile, h, d):
    g = _graph(4)
    se, de = ell_dual(g, profile=profile)
    z, a_l, a_r, dy = _inputs(h * d, g.n_nodes, h, d)
    want = _plain(de, se, a_l, a_r, z, dy)
    got = _mirror(de, se, a_l, a_r, z, dy)
    for name, w, x in zip(("out", "d_a_l", "d_a_r", "dz"), want, got):
        assert torch.isfinite(x).all(), name
        torch.testing.assert_close(x, w, rtol=1e-4,
                                   atol=1e-5 * float(w.abs().max()),
                                   msg=name)
    # The zero rows: no in-edges → out 0; neither → dz 0.
    n = g.n_nodes
    assert not got[0][n - 30: n - 20].any()
    assert not got[3][n - 10:].any()


def _counts():
    return [(f.launches, f.launches_bf16, f.launches_whole_row)
            for f in SWEEPS]


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    def refuse():
        raise AssertionError("the CPU path built or loaded the library")

    monkeypatch.setattr(_build, "library", refuse)
    before = _counts()
    g = _graph(5)
    se, de = ell_dual(g)
    for dtype in (torch.float32, torch.bfloat16):
        z, a_l, a_r, dy = _inputs(5, g.n_nodes, 2, 8, dtype)
        z.requires_grad_()
        a_l.requires_grad_()
        a_r.requires_grad_()
        out = ell_gat_attention(de, se, a_l, a_r, z)
        got = torch.autograd.grad(out, (a_l, a_r, z), dy)
        want = _plain(de, se, a_l.detach(), a_r.detach(), z.detach(), dy)
        for x, w in zip((out,) + got, want):
            assert x.dtype == dtype and torch.equal(x, w)
    assert _counts() == before


def _offset(t: torch.Tensor, k: int) -> torch.Tensor:
    """A contiguous copy of t whose base lies k elements past an aligned
    allocation."""
    buf = t.new_empty(t.numel() + k)
    buf[k:].copy_(t.reshape(-1))
    return buf[k:].view(t.shape)


# (h, d, base offset in elements, the lane mode): 16-byte lanes (4) where
# d % 4 == 0 and the bases allow, whole rows at 2 or 1 features a load up
# to ROW_HEADS heads, else one float a lane in chunks (0).
LANE_CASES = [(3, 250, 0, 2), (2, 33, 0, 1), (4, 128, 2, 2), (4, 128, 1, 1),
              (4, 128, 0, 4), (1, 40, 0, 4), (4, 300, 0, 4), (3, 250, 1, 1),
              (kg.ROW_HEADS + 1, 3, 0, 0), (kg.ROW_HEADS + 1, 4, 0, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h, d, offset, mode", LANE_CASES)
def test_the_path_follows_the_shape_and_alignment(h, d, offset, mode,
                                                  dtype):
    z = _offset(torch.zeros(3, h, d, dtype=dtype), offset)
    align = 4 if offset == 0 else 2 if offset % 2 == 0 else 1
    assert kg.lane_mode(h, d, align) == mode
    assert kg._lanes(h, d, z, torch.empty_like(z)) == mode


# (row width, features a load) → (features a lane holds, tasks a row).
LAYOUTS = [(750, 2, 24, 1), (66, 1, 4, 1), (1200, 2, 24, 2), (750, 1, 12, 2),
           (753, 1, 12, 2), (512, 2, 24, 1), (40, 2, 8, 1), (1, 1, 4, 1)]


@pytest.mark.parametrize("width, pw, per_lane, tasks", LAYOUTS)
def test_whole_row_layout(width, pw, per_lane, tasks):
    """Each feature of the row is one lane's, once: task t, lane l, load c
    take features t·32·K + 32·pw·c + l·pw .. + pw − 1 (K the features a
    lane holds); with pw = 2 a load's pair starts at an even feature, so
    it lies in one head of any even d."""
    assert kg.whole_row_layout(width, pw) == (per_lane, tasks)
    loads = per_lane // pw
    assert loads in (kg.ROW_LOADS_NARROW, kg.ROW_LOADS)
    f = (torch.arange(tasks)[:, None, None, None] * 32 * per_lane
         + 32 * pw * torch.arange(loads)[None, :, None, None]
         + pw * torch.arange(32)[None, None, :, None]
         + torch.arange(pw)).reshape(-1)
    f = f[f < width]
    assert torch.equal(f.sort().values, torch.arange(width))
    if pw == 2:
        assert torch.equal(f[1::2], f[::2] + 1) and not (f[::2] % 2).any()


def test_the_source_agrees_with_the_wrappers():
    assert "ell_gat.cu" in _build.SOURCES
    text = (_build.CSRC / "ell_gat.cu").read_text()
    assert '#include "ell_table.cuh"' in text
    text += (_build.CSRC / "ell_table.cuh").read_text()
    for name, value in (("PIECE", PIECE), ("MAX_BUCKETS", MAX_BUCKETS),
                        ("NODE_CHUNK", kg.NODE_CHUNK),
                        ("ROW_LOADS", kg.ROW_LOADS),
                        ("ROW_LOADS_NARROW", kg.ROW_LOADS_NARROW),
                        ("ROW_HEADS", kg.ROW_HEADS),
                        ("DOT_CHUNKS", kg.DOT_CHUNKS)):
        assert re.search(rf"constexpr int {name} = (\d+);",
                         text).group(1) == str(value), name
    assert re.search(r"MASK_VALUE = (-1e30)f;", text)
    assert re.search(r"DENOM_FLOOR = (1e-30)f;", text)
    assert MASK_VALUE == -1e30 and DENOM_FLOOR == 1e-30
    # No atomic function (atomicAdd, atomicCAS, ...) and no PTX atom/red.
    assert not re.search(r"\batomic[A-Z]\w*\s*\(|\batom\.|\bred\.", text)
    for sweep in ("fwd", "bwd_dst", "bwd_src"):
        assert (_build._SIGNATURES[f"ell_gat_{sweep}_bf16"]
                == _build._SIGNATURES[f"ell_gat_{sweep}_f32"])


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _kernel(de, se, a_l, a_r, z, dy):
    leaves = [t.detach().clone().requires_grad_() for t in (a_l, a_r, z)]
    out = ell_gat_attention(de, se, *leaves)
    return (out,) + torch.autograd.grad(out, leaves, dy)


def _close(name, got, want, bf16):
    got, want = got.float(), want.float()
    big = float(want.abs().max())
    if bf16:     # one bf16 rounding each side, sums in another order
        tol = 2.0 ** -7 * want.abs() + 1e-3 * big
    else:
        tol = 1e-5 * want.abs() + 1e-5 * big
    err = (got - want).abs()
    assert (err <= tol).all(), (name, float(err.max()), big)


@pytest.mark.chip
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h, d", SHAPES)
@pytest.mark.parametrize("profile", PROFILES)
def test_kernels_match_the_plain_path(cuda, profile, h, d, dtype):
    g = _graph(6, device=cuda)
    se, de = ell_dual(g, profile=profile)
    assert max(b.width for b in de.buckets) > PIECE
    assert max(b.width for b in se.buckets) > PIECE
    z, a_l, a_r, dy = _inputs(h + d, g.n_nodes, h, d, dtype, cuda)
    before = [f.launches_bf16 if dtype == torch.bfloat16 else f.launches
              for f in SWEEPS]
    got = _kernel(de, se, a_l, a_r, z, dy)
    after = [f.launches_bf16 if dtype == torch.bfloat16 else f.launches
             for f in SWEEPS]
    assert [b - a for a, b in zip(before, after)] == [1, 1, 1]
    want = _plain(de, se, a_l, a_r, z, dy)
    for name, x, w in zip(("out", "d_a_l", "d_a_r", "dz"), got, want):
        assert x.dtype == w.dtype and x.shape == w.shape, name
        _close(name, x, w, dtype == torch.bfloat16)
    again = _kernel(de, se, a_l, a_r, z, dy)
    for x, y in zip(got, again):
        assert torch.equal(x, y)


def _sweeps(de, se, a_l, a_r, z, dy):
    """The three sweeps called directly on z and dy as given (their bases
    kept): (out, d_a_l, d_a_r, dz)."""
    out, alpha, el, er = kg.gat_forward(de, a_l, a_r, z, SLOPE)
    ad, der = kg.gat_backward_dst(de, z, dy, alpha, el, er, SLOPE)
    return (out,) + kg.gat_backward_src(se, a_l, a_r, z, dy, ad, der)


# (h, d, base offset of z and dy in elements, the dst term, the lane
# mode): whole rows at 2 features a load (DGL's (3, 250) with and without
# the dst term; (4, 300) two elements off, 1200 features, two tasks a
# row; (4, 128) two elements off) and at 1 ((2, 33); (3, 251), two tasks
# a row); more than ROW_HEADS heads keep the chunked sums (0).
WHOLE_ROW = [(3, 250, 0, True, 2), (3, 250, 0, False, 2), (2, 33, 0, True, 1),
             (4, 300, 2, True, 2), (4, 128, 2, True, 2), (3, 251, 0, True, 1),
             (kg.ROW_HEADS + 1, 3, 0, True, 0)]


@pytest.mark.chip
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h, d, offset, has_dst, mode", WHOLE_ROW)
def test_whole_rows_match_the_plain_path(cuda, monkeypatch, h, d, offset,
                                         has_dst, mode, dtype):
    """On the hub graph (the sums' pieces and combine run) against the
    plain path at the tolerances above, bit for bit on repeat, and bit for
    bit against the one-float chunked sums: each feature sums its slots in
    the same order, and the dot sweep's lanes hold the same features."""
    g = _graph(6, device=cuda)
    se, de = ell_dual(g, profile="train")
    assert max(b.width for b in se.buckets) > PIECE
    z, a_l, a_r, dy = _inputs(h + d, g.n_nodes, h, d, dtype, cuda)
    z, dy = _offset(z, offset), _offset(dy, offset)
    if not has_dst:
        a_r = None
    assert kg._lanes(h, d, z, dy) == mode
    before = [f.launches_whole_row for f in SWEEPS]
    got = _sweeps(de, se, a_l, a_r, z, dy)
    after = [f.launches_whole_row for f in SWEEPS]
    assert [b - a for a, b in zip(before, after)] == [int(mode > 0)] * 3
    want = _plain(de, se, a_l, a_r, z, dy)
    for name, x, w in zip(("out", "d_a_l", "d_a_r", "dz"), got, want):
        if w is None:
            assert x is None and not has_dst, name
            continue
        assert x.dtype == w.dtype and x.shape == w.shape, name
        _close(name, x, w, dtype == torch.bfloat16)
    again = _sweeps(de, se, a_l, a_r, z, dy)
    monkeypatch.setattr(kg, "lane_mode", lambda h, d, align: 0)
    chunked = _sweeps(de, se, a_l, a_r, z, dy)
    assert [f.launches_whole_row for f in SWEEPS] == [
        a + 2 * int(mode > 0) for a in before]
    for name, x, y, c in zip(("out", "d_a_l", "d_a_r", "dz"), got, again,
                             chunked):
        if x is not None:
            assert torch.equal(x, y) and torch.equal(x, c), name


@pytest.mark.chip
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_gat_step_counts_its_sweeps(cuda, dtype):
    g = _graph(7, device=cuda)
    ell = ell_dual(g, profile="train")
    torch.manual_seed(7)
    model = GAT(hidden_dim=32, out_dim=40, num_layers=3, num_heads=4,
                in_dim=24, device=cuda,
                dtype=None if dtype == torch.float32 else dtype)
    x = torch.randn(g.n_nodes, 24, generator=torch.Generator().manual_seed(8))
    attr = "launches_bf16" if dtype == torch.bfloat16 else "launches"
    other = "launches" if dtype == torch.bfloat16 else "launches_bf16"
    before = [(getattr(f, attr), getattr(f, other)) for f in SWEEPS]
    whole = [f.launches_whole_row for f in SWEEPS]
    model(g, x.to(cuda), ell=ell).square().sum().backward()
    torch.cuda.synchronize()
    after = [(getattr(f, attr), getattr(f, other)) for f in SWEEPS]
    # Three layers: a forward sweep each, and both backward passes each.
    assert [(a - b, c - e) for (b, e), (a, c) in zip(before, after)] == [
        (3, 0), (3, 0), (3, 0)]
    # (4, 32) and (1, 40), as arxiv_gat's (4, 128) and (1, 40): every
    # sweep on 16-byte lanes.
    assert [f.launches_whole_row for f in SWEEPS] == whole
    for p in model.parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all()


@pytest.mark.chip
def test_no_gathered_tile_in_the_peak(cuda):
    h, d = 4, 128
    g = random_graph(4000, 120_000, seed=9).to(cuda)
    se, de = ell_dual(g, profile="train")
    tile = max(b.num_rows * b.width for b in de.buckets) * h * d * 4
    z, a_l, a_r, dy = _inputs(9, g.n_nodes, h, d, device=cuda)
    _kernel(de, se, a_l, a_r, z, dy)             # builds, caches the maps
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    _kernel(de, se, a_l, a_r, z, dy)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda) - base
    # The op's outputs and residuals are node and slot arrays: out, dz, the
    # leaves' copies (3 node arrays of 8 MB), α and (α, dpre) (16 B and
    # 32 B a slot); the widest bucket's gathered tile alone is larger.
    assert peak < tile / 2, (peak, tile)
