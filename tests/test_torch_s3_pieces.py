"""S3's row engine on Hopper (csrc/gather_sum.cu): its decomposition of
long rows into pieces, mirrored in numpy, and both plain versions against
the JAX package at the row lengths the pieces change.

- The mirror enumerates the kernel's tasks as csrc/gather_sum.cu numbers
  them (ELL: each bucket's rows times ceil(D / PIECE) pieces, from the
  table; CSR: windows of PIECE slots found by binary search in ptr, then
  rows) and shows that every slot is summed once, a row's pieces are in
  slot order and combined in that order, and the launch the host sizes
  (``ell_launch``, the CSR window count) bounds the tasks; the search in
  ptr that a row's G lanes share finds every slot's row. It also runs
  the kernel's f32 arithmetic (Kahan in each piece, partials combined
  compensated): the 27,565-slot hub of the power-law suite's graph, and
  a row of each length, stay within 1e-4 relative of an f64 sum.
- ``gather_sum`` and ``csr_sum`` on the CPU (their plain versions) against
  JAX's ``xla_gather_sum`` (scripts/exp_pallas_gather.py), one case of
  ``pallas_gather_sum(interpret=True)``, and JAX's ``segment_sum``
  (custom_op_benchmark_tpu/ops/xla.py), on rows of 0, 1, PIECE - 1,
  PIECE, PIECE + 1, 4 PIECE + 3 and 27,565 slots, pad-heavy rows, d in
  {1, 3, 4, 8, 64, 128, 300}, f32 (1e-4 of the largest value) and bf16
  (one bf16 rounding of JAX's f32 sum: 2⁻⁷·|JAX| + 1e-4·max|JAX|).
- Source checks: the C entry points' parameters against
  ``_build._SIGNATURES``, PIECE of the host side against the source (the
  row engine's header csrc/ell_table.cuh), and no atomic in
  csrc/gather_sum.cu or its header.
"""

import ctypes
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))

import exp_pallas_gather as jax_gather  # noqa: E402

from custom_op_benchmark_tpu import ops as jops  # noqa: E402
from custom_op_benchmark_tpu_torch.graph.ell import (  # noqa: E402
    PIECE,
    GatherTable,
    ell_launch,
    one_bucket_table,
)
from custom_op_benchmark_tpu_torch.ops.kernels import _build  # noqa: E402
from custom_op_benchmark_tpu_torch.ops.kernels import (  # noqa: E402
    gather_sum as ks,
)

L = PIECE
HUB = 27_565        # the largest src row of random_graph(131072, 2M, power_law)
LENGTHS = (0, 1, L - 1, L, L + 1, 4 * L + 3, HUB)
WIDTHS = (1, 3, 4, 8, 64, 128, 300)
SOURCE = _build.CSRC / "gather_sum.cu"
# The row engine's table, task numbering and constants, shared with the GAT
# attention's sweeps (csrc/ell_gat.cu).
HEADER = _build.CSRC / "ell_table.cuh"


# ---------------------------------------------------------------------------
# The mirror of the kernel's decomposition
# ---------------------------------------------------------------------------

def ell_tasks(layout, n_zero):
    """Pass 1 and pass 2 of the ELL entry as the kernel numbers them:
    pass 1 a list of ("row", bucket, row, piece, k0, k1, partial index or
    None) in unit order, then ("zero", z); pass 2 a list of (bucket, row,
    first partial, pieces)."""
    pass1, pass2 = [], []
    part = 0
    for b, (_, w, _, rows) in enumerate(layout):
        p = -(-w // L) if w > L else 1
        for r in range(rows):
            for q in range(p):
                k0, k1 = q * L, min(w, (q + 1) * L)
                pass1.append(("row", b, r, q, k0, k1,
                              None if p == 1 else part + r * p + q))
            if p > 1:
                pass2.append((b, r, part + r * p, p))
        if p > 1:
            part += rows * p
    pass1 += [("zero", z) for z in range(n_zero)]
    return pass1, pass2


def row_of(ptr, k):
    """The kernel's binary search: last r with ptr[r] <= k, -1 before."""
    if ptr[0] > k:
        return -1
    lo, hi = 0, len(ptr)
    while hi - lo > 1:
        mid = lo + (hi - lo) // 2
        if ptr[mid] <= k:
            lo = mid
        else:
            hi = mid
    return lo


def row_from(ptr, k, lo, near, G):
    """The kernel's search shared by a row's G lanes (csrc/gather_sum.cu
    row_from): G rows probed a step, the range kept after the last row not
    past k; with ``near`` the first step probes the G rows from lo on.
    Returns (row, steps)."""
    hi, steps = len(ptr), 0
    if G == 1:
        while hi - lo > 1:
            mid = lo + (hi - lo) // 2
            lo, hi = (mid, hi) if ptr[mid] <= k else (lo, mid)
            steps += 1
        return lo, steps
    step = 1 if near else 0
    while hi - lo > 1:
        if step == 0:
            step = -(-(hi - lo) // G)
        probes = [lo + i * step for i in range(G)]
        ok = [p < hi and ptr[p] <= k for p in probes]
        j = max(i for i, o in enumerate(ok) if o)
        if j < G - 1:
            hi = min(hi, lo + (j + 1) * step)
        lo += j * step
        step, steps = 0, steps + 1
    return lo, steps


@pytest.mark.parametrize("G", [1, 2, 4, 8, 16, 32])
def test_the_group_search_finds_the_row_of_a_slot(G):
    """Every slot's row (empty rows included) is the last r with ptr[r] <=
    k, from row 0 and from a row before it with ``near``; the steps stay
    within log_G of the rows (plus the near step)."""
    rng = np.random.default_rng(G)
    lengths = rng.choice([0, 0, 1, 3, 41, 300], size=2000)
    ptr = _ptr(lengths)
    n_rows = len(lengths)
    bound = int(np.ceil(np.log(n_rows + 1) / np.log(max(G, 2)))) + 2
    for k in rng.integers(0, int(ptr[-1]) + 5, size=300):
        want = int(np.searchsorted(ptr, k, side="right")) - 1
        got, steps = row_from(ptr, k, 0, False, G)
        assert got == want and (G == 1 or steps <= bound)
        lo = max(0, want - int(rng.integers(0, 40)))
        while ptr[lo] > k:
            lo -= 1
        assert row_from(ptr, k, lo, True, G)[0] == want


def csr_tasks(ptr, n_slots):
    """Pass 1 of the CSR entry: per window t its segments [(partial index,
    row, k0, k1)] and the long row that ends in it (or -1); then each row
    unit's (row, lo, hi) it sums itself. Pass 2: per window with an end,
    (row, [partial indices in order])."""
    n_rows = len(ptr) - 1
    n_windows = -(-n_slots // L)

    def span(r):
        lo = min(ptr[r], n_slots)
        return lo, max(lo, min(ptr[r + 1], n_slots))

    windows, ends = [], []
    for t in range(n_windows):
        w0 = t * L
        w1 = w0 + min(L, n_slots - w0)
        segs, end = [], -1
        a = row_of(ptr, w0)
        if 0 <= a < n_rows:
            lo, hi = span(a)
            if hi - lo > L:
                segs.append((2 * t, a, w0, min(w1, hi)))
                if hi <= w1:
                    end = a
        b = row_of(ptr, w1 - 1)
        if b != a and 0 <= b < n_rows:
            lo, hi = span(b)
            if hi - lo > L:
                segs.append((2 * t + 1, b, lo, w1))
        windows.append(segs)
        ends.append(end)
    rows = [(r, *span(r)) for r in range(n_rows)
            if span(r)[1] - span(r)[0] <= L]
    combine = []
    for t, r in enumerate(ends):
        if r < 0:
            continue
        lo = span(r)[0]
        t0 = lo // L
        combine.append((r, [2 * p + int(p == t0 and lo != t0 * L)
                            for p in range(t0, t + 1)]))
    return windows, rows, combine, n_windows + n_rows


def _ptr(lengths, start=0):
    return np.concatenate([[start], start + np.cumsum(lengths)]).astype(
        np.int64)


LENGTH_SETS = {
    "hub and piece lengths": list(LENGTHS),
    "shuffled": [L + 1, 0, HUB, 1, 0, L, 4 * L + 3, L - 1, 2 * L, 3],
    "adjacent long rows": [L + 1] * 5 + [2 * L + 1, L + 7],
    "short only": [3, 0, 41, L, 17] * 20,
}


@pytest.mark.parametrize("name", sorted(LENGTH_SETS))
@pytest.mark.parametrize("start", [0, 5])
def test_csr_windows_cover_every_slot_once_in_order(name, start):
    lengths = LENGTH_SETS[name]
    ptr = _ptr(lengths, start)
    n_slots = int(ptr[-1]) + 3        # idx a little longer than the rows
    windows, rows, combine, units = csr_tasks(ptr, n_slots)
    covered = np.zeros(n_slots, dtype=int)
    pieces = {}
    for segs in windows:
        for part, r, k0, k1 in segs:
            assert k0 < k1 and k1 - k0 <= L
            covered[k0:k1] += 1
            pieces.setdefault(r, []).append((part, k0, k1))
    for r, lo, hi in rows:
        covered[lo:hi] += 1
    want = np.zeros(n_slots, dtype=int)
    want[ptr[0]:ptr[-1]] = 1
    np.testing.assert_array_equal(covered, want)
    # Each long row: its pieces tile its slots in order, it is named once
    # by the window holding its end, and the combine reads its partials in
    # that order.
    long_rows = [r for r, n in enumerate(lengths) if n > L]
    assert sorted(pieces) == long_rows
    assert sorted(r for r, _ in combine) == long_rows
    for r, parts in combine:
        segs = pieces[r]
        assert [p for p, _, _ in segs] == parts
        assert segs[0][1] == ptr[r] and segs[-1][2] == ptr[r + 1]
        assert all(a[2] == b[1] for a, b in zip(segs, segs[1:]))
    # Every partial index is written once, inside the window's two slots.
    written = [p for segs in windows for p, _, _, _ in segs]
    assert len(written) == len(set(written))
    assert max(written, default=0) < 2 * -(-n_slots // L)
    assert units == -(-n_slots // L) + len(lengths)


def test_csr_rows_past_the_slots_are_clipped():
    """Slots at or past n_slots add zero: a row is clipped there, and a
    row clipped to PIECE slots or fewer is summed by its own task."""
    ptr = _ptr([L + 10, 3 * L, 5])
    n_slots = L + 10 + L - 2         # the second row keeps L - 2 slots
    windows, rows, combine, _ = csr_tasks(ptr, n_slots)
    assert (1, L + 10, n_slots) in rows and (2, n_slots, n_slots) in rows
    assert [r for r, _ in combine] == [0]


def _table(lengths_rows, n_zero=1):
    layout, off, first = [], 0, 0
    for w, rows in lengths_rows:
        layout.append((off, w, first, rows))
        off += w * rows
        first += rows
    return tuple(layout), off, first, n_zero


@pytest.mark.parametrize("bucket_rows", [
    [(HUB, 1), (4 * L + 3, 2), (L + 1, 3), (L, 2), (L - 1, 1), (1, 4)],
    [(2 * L, 5), (L, 7), (8, 9)],
    [(16, 100)],
])
def test_ell_pieces_follow_the_table(bucket_rows):
    layout, slots, n_rows, n_zero = _table(bucket_rows)
    pass1, pass2 = ell_tasks(layout, n_zero)
    # Each row's pieces are consecutive units that tile [0, D) in order.
    by_row = {}
    for task in pass1:
        if task[0] == "row":
            _, b, r, q, k0, k1, part = task
            by_row.setdefault((b, r), []).append((q, k0, k1, part))
    for (b, r), pieces in by_row.items():
        w = layout[b][1]
        assert [q for q, *_ in pieces] == list(range(len(pieces)))
        assert pieces[0][1] == 0 and pieces[-1][2] == w
        assert all(a[2] == c[1] for a, c in zip(pieces, pieces[1:]))
        assert all(k1 - k0 <= L for _, k0, k1, _ in pieces)
        parts = [p for *_, p in pieces]
        if len(pieces) == 1:
            assert parts == [None]
        else:
            assert parts == list(range(parts[0], parts[0] + len(parts)))
    assert sum(1 for t in pass1 if t[0] == "row") == sum(
        max(1, -(-w // L)) * rows for _, w, _, rows in layout)
    # The host's launch, from the layout.
    tab = GatherTable(
        buckets=torch.tensor([e[:3] for e in layout], dtype=torch.int32),
        cols=torch.zeros(slots, dtype=torch.int32),
        nodes=torch.arange(n_rows, dtype=torch.int32),
        zero_nodes=torch.tensor([n_rows], dtype=torch.int32),
        n_out=n_rows + 1, layout=layout)
    units, split, pieces = ell_launch(tab)
    assert units == len(pass1) and split == len(pass2)
    assert pieces == sum(p for *_, p in pass2)
    assert [first for _, _, first, _ in pass2] == list(np.cumsum(
        [0] + [p for *_, p in pass2])[:-1])


def test_the_packing_carries_its_layout():
    """The table of a packing keeps the host's copy of its buckets, equal
    to the device table, so the wrapper reads nothing from the card."""
    from custom_op_benchmark_tpu_torch.graph import random_graph
    from custom_op_benchmark_tpu_torch.ops import ell_dual

    g = random_graph(3000, 60_000, seed=4, power_law=True)
    for eg in ell_dual(g):
        tab = eg.gather_table
        b = tab.buckets.tolist()
        ends = [r for _, _, r in b[1:]] + [tab.nodes.shape[0]]
        assert [tuple(e) for e in tab.layout] == [
            (o, w, r, e - r) for (o, w, r), e in zip(b, ends)]
        assert ell_launch(tab)[0] >= tab.nodes.shape[0]
    assert max(w for _, w, _, _ in ell_dual(g)[0].gather_table.layout) > L


# ---------------------------------------------------------------------------
# The kernel's f32 arithmetic, in numpy
# ---------------------------------------------------------------------------

def kahan(rows):
    """Kahan sums of ``rows`` (k, ...) float32 in order: (sum, carry)."""
    s = np.zeros(rows.shape[1:], np.float32)
    c = np.zeros(rows.shape[1:], np.float32)
    for v in rows:
        y = v - c
        t = s + y
        c = (t - s) - y
        s = t
    return s, c


def pieces_sum(rows):
    """A long row as the kernel sums it: Kahan in each piece of L slots,
    then the partials combined in order, compensated."""
    s = np.zeros(rows.shape[1:], np.float32)
    c = np.zeros(rows.shape[1:], np.float32)
    for k0 in range(0, len(rows), L):
        ps, pc = kahan(rows[k0:k0 + L])
        for v in (ps, -pc):
            y = v - c
            t = s + y
            c = (t - s) - y
            s = t
    return s


def test_hub_row_in_pieces_is_within_1e_4_of_f64():
    rng = np.random.default_rng(13)
    rows = rng.standard_normal((HUB, 8)).astype(np.float32) + 0.3
    exact = rows.astype(np.float64).sum(0)
    got = pieces_sum(rows)
    rel = np.abs(got - exact).max() / np.abs(exact).max()
    assert rel < 1e-4, rel
    # A plain running f32 sum, for scale: the compensated pieces are far
    # closer to the exact sum.
    plain = np.zeros(8, np.float32)
    for v in rows:
        plain = plain + v
    assert np.abs(got - exact).max() <= np.abs(plain - exact).max()


@pytest.mark.parametrize("length", LENGTHS[1:])
def test_every_length_is_within_1e_4_of_f64(length):
    """The kernel's arithmetic for one row: one Kahan chain up to PIECE
    slots (stored as it is, as the earlier kernel did), pieces combined
    above; within 1e-4 of the largest f64 sum at every length."""
    rng = np.random.default_rng(length)
    rows = rng.standard_normal((length, 4)).astype(np.float32)
    got = kahan(rows)[0] if length <= L else pieces_sum(rows)
    exact = rows.astype(np.float64).sum(0)
    assert np.abs(got - exact).max() <= 1e-4 * np.abs(exact).max() + 1e-6


# ---------------------------------------------------------------------------
# Both plain versions against JAX
# ---------------------------------------------------------------------------

def _x(seed, n, d):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _close(got, want, bf16):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    top = np.abs(want).max() if want.size else 0.0
    if bf16:
        tol = 2.0 ** -7 * np.abs(want) + 1e-4 * top
    else:
        tol = 1e-4 * top + 1e-6
    assert got.shape == want.shape
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


def _buckets(seed, n, pad_share):
    """One bucket per length (two rows each; length 0 none): column ids in
    [0, n), a ``pad_share`` of them the pad column n, a few -1."""
    rng = np.random.default_rng(seed)
    out = []
    for w in LENGTHS[1:]:
        cols = rng.integers(0, n, size=(2, w)).astype(np.int32)
        cols[rng.random(cols.shape) < pad_share] = n
        cols[:, ::97] = np.where(cols[:, ::97] == n, -1, cols[:, ::97])
        out.append(cols)
    return out


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pad_share", [0.0, 0.9])
def test_gather_sum_plain_matches_jax(d, dtype, pad_share):
    n = 500
    x = _x(d, n, d)
    bf16 = dtype == "bf16"
    xt = torch.from_numpy(x)
    if bf16:
        xt = xt.bfloat16()
        x = xt.float().numpy()             # JAX sums the rounded values
    xz = jnp.asarray(np.concatenate([x, np.zeros((1, d), np.float32)]))
    buckets = _buckets(d + 100, n, pad_share)
    layout, off, first, cols = [], 0, 0, []
    for c in sorted(buckets, key=lambda c: -c.shape[1]):
        layout.append((off, c.shape[1], first, c.shape[0]))
        cols.append(c.reshape(-1))
        off += c.size
        first += c.shape[0]
    nodes = np.random.default_rng(d).permutation(first + 1).astype(np.int32)
    table = GatherTable(
        buckets=torch.tensor([e[:3] for e in layout], dtype=torch.int32),
        cols=torch.from_numpy(np.concatenate(cols)),
        nodes=torch.from_numpy(nodes[:first]),
        zero_nodes=torch.from_numpy(nodes[first:]), n_out=first + 1,
        layout=tuple(layout))
    got = ks.gather_sum(table, xt)
    assert got.dtype == xt.dtype
    want = np.zeros((first + 1, d), np.float32)
    row = 0
    for c in sorted(buckets, key=lambda c: -c.shape[1]):
        cz = np.where((c >= 0) & (c < n), c, n)
        want[nodes[row: row + c.shape[0]]] = np.asarray(
            jax_gather.xla_gather_sum(jnp.asarray(cz), xz))
        row += c.shape[0]
    _close(got.float().numpy(), want, bf16)


def test_gather_sum_plain_matches_the_pallas_kernel_past_a_piece():
    """A bucket of PIECE + 1 slots, a third of them pads (the pad row of
    zeros appended for JAX), through the Pallas kernel in interpret mode."""
    n, d = 300, 8
    x = _x(7, n, d)
    cols = np.random.default_rng(8).integers(0, n, size=(8, L + 1))
    cols[:, ::3] = n
    cols = cols.astype(np.int32)
    xz = np.concatenate([x, np.zeros((1, d), np.float32)])
    want = np.asarray(jax_gather.pallas_gather_sum(
        jnp.asarray(cols), jnp.asarray(xz), interpret=True))
    got = ks.gather_sum(torch.from_numpy(cols), torch.from_numpy(x))
    _close(got.numpy(), want, False)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("slots", ["idx", "identity"])
def test_csr_sum_plain_matches_jax_segment_sum(d, dtype, slots):
    lengths = LENGTH_SETS["shuffled"]
    ptr = _ptr(lengths)
    e, n_rows = int(ptr[-1]), len(lengths)
    bf16 = dtype == "bf16"
    n = 700 if slots == "idx" else e
    x = _x(d + 1, n, d)
    xt = torch.from_numpy(x)
    if bf16:
        xt = xt.bfloat16()
        x = xt.float().numpy()
    idx = (np.random.default_rng(d).integers(0, n, size=e).astype(np.int32)
           if slots == "idx" else None)
    got = ks.csr_sum(torch.from_numpy(ptr.astype(np.int32)), xt,
                     None if idx is None else torch.from_numpy(idx))
    seg = np.repeat(np.arange(n_rows), lengths).astype(np.int32)
    vals = x[idx] if idx is not None else x
    want = np.asarray(jops.xla.segment_sum(
        jnp.asarray(vals), jnp.asarray(seg), n_rows, sorted_ids=True))
    _close(got.float().numpy(), want, bf16)


# ---------------------------------------------------------------------------
# Source checks
# ---------------------------------------------------------------------------

_CTYPES = {"int": ctypes.c_int, "unsigned": ctypes.c_int,
           "float": ctypes.c_float}


def _extern_c(text):
    """{name: [ctypes type of each parameter]} of the functions an
    ``extern "C"`` block of a source defines."""
    out = {}
    for block in re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"', text,
                            re.S):
        for name, params in re.findall(r"\nint (\w+)\(([^)]*)\)", block):
            types = []
            for p in params.split(","):
                p = " ".join(p.split())
                if "*" in p or p.startswith("cudaStream_t"):
                    types.append(ctypes.c_void_p)
                else:
                    types.append(_CTYPES[p.rsplit(" ", 1)[0]])
            out[name] = types
    return out


def test_signatures_agree_with_the_sources():
    declared = {}
    for name in _build.SOURCES:
        declared.update(_extern_c((_build.CSRC / name).read_text()))
    assert {"gather_sum_f32", "gather_sum_bf16", "csr_sum_f32",
            "csr_sum_bf16", "l2_probe_f32"} <= set(declared)
    assert set(declared) == set(_build._SIGNATURES)
    for name, types in declared.items():
        assert _build._SIGNATURES[name] == types, name


def test_piece_and_no_atomics_in_the_source():
    text = SOURCE.read_text() + HEADER.read_text()
    assert '#include "ell_table.cuh"' in SOURCE.read_text()
    assert re.search(r"constexpr int PIECE = (\d+);", text).group(1) == str(L)
    # No atomic function (atomicAdd, atomicCAS, ...) and no PTX atom/red.
    assert not re.search(r"\batomic[A-Z]\w*\s*\(|\batom\.|\bred\.", text)
    assert "l2_probe.cu" in _build.SOURCES


def test_one_bucket_table_has_its_layout():
    cols = torch.zeros((5, L + 3), dtype=torch.int32)
    tab = one_bucket_table(cols)
    assert tab.layout == ((0, L + 3, 0, 5),)
    assert ell_launch(tab) == (10, 5, 10)
