"""The port's native halo planner and packer against its numpy builders.

Counterpart of tests/test_halo_native.py: ``halo_plan_native`` and
``halo_pack_native`` (the port's own graphcore library,
``custom_op_benchmark_tpu_torch/csrc/graphcore.cpp``) must give exactly
the arrays of the numpy builders in ``parallel/halo.py``, on the
reference's six randomised graphs (uniform and zipf, P = 2, 4 or 8),
every ``HaloGraph`` and ``HaloEll`` array compared element for element.
Also the halo case of tests/test_packing_properties.py:118 on the same
graph zoo: every real edge on the shard that owns its dst, and
``recv_pos`` the inverse of ``send_idx``.
"""

import numpy as np
import pytest

from custom_op_benchmark_tpu_torch.graph import from_coo, native, random_graph
from custom_op_benchmark_tpu_torch.parallel import halo, make_mesh

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="the graphcore library does not "
                                       "build here")


def _ell_arrays(he):
    out = {}
    for name in ("rows_b", "cols_b", "epos_b", "rows_t_b", "cols_t_b",
                 "epos_t_b", "twin_pos_t"):
        out[name] = [a.numpy() for a in getattr(he, name)]
    for name in ("row_pos", "row_pos_t", "slot_pos", "halo_pos_t",
                 "recv_pos"):
        out[name] = getattr(he, name).numpy()
    for name in ("n_bnd", "widths", "halo_rows_t", "n_halo_t", "total_rows",
                 "total_rows_t"):
        out[name] = getattr(he, name)
    return out


@pytest.mark.parametrize("trial", range(6))
def test_halo_native_bitwise_parity(trial, monkeypatch):
    rng = np.random.default_rng(100 + trial)
    n = int(rng.integers(40, 2500))
    e = int(rng.integers(1, 5 * n))
    p = int(rng.choice([2, 4, 8]))
    src = rng.integers(0, n, size=e)
    dst = rng.integers(0, n, size=e)
    if trial % 3 == 2:  # power-law-ish dst (hub rows, wide buckets)
        dst = (rng.zipf(1.5, size=e) - 1) % n
    g = from_coo(src, dst, n_nodes=n)
    mesh = make_mesh((p,), ("edge",), device="cpu")

    calls = (native.halo_plan_native.calls, native.halo_pack_native.calls)
    hg_nat = halo.halo_graph(g, mesh)
    he_nat = halo.halo_ell(hg_nat, mesh)
    assert (hg_nat.route, he_nat.route) == ("native", "native")
    assert (native.halo_plan_native.calls - calls[0],
            native.halo_pack_native.calls - calls[1]) == (1, 2)
    nat = _ell_arrays(he_nat)

    monkeypatch.setattr(native, "_load", lambda: None)
    hg_np = halo.halo_graph(g, mesh)
    he_np = halo.halo_ell(hg_np, mesh)
    assert (hg_np.route, he_np.route) == ("numpy", "numpy")
    for f in ("send_idx", "src_ext", "dst_loc", "eid", "recv_pos"):
        x, y = getattr(hg_nat, f).numpy(), getattr(hg_np, f).numpy()
        assert x.shape == y.shape and (x == y).all(), ("plan", f)
    num = _ell_arrays(he_np)
    assert set(nat) == set(num)
    for key in nat:
        a, b = nat[key], num[key]
        if isinstance(a, list):
            assert len(a) == len(b), key
            for i, (x, y) in enumerate(zip(a, b)):
                assert x.shape == y.shape and (x == y).all(), (key, i)
        elif isinstance(a, np.ndarray):
            assert a.shape == b.shape and (a == b).all(), key
        else:
            assert a == b, key


def _graph_zoo():
    """tests/test_packing_properties.py's zoo, built by the port."""
    rng = np.random.default_rng(7)
    zoo = []
    for seed, (n, e, pl) in enumerate([
        (50, 200, False), (200, 1500, True), (64, 64, False),
        (300, 4000, True), (17, 40, False),
    ]):
        zoo.append(random_graph(n, e, seed=seed, power_law=pl))
    n = 40
    zoo.append(from_coo(np.arange(1, n), np.zeros(n - 1, int), n))
    zoo.append(from_coo(np.r_[np.arange(n - 1), np.arange(n)],
                        np.r_[np.arange(1, n), np.arange(n)], n))
    zoo.append(from_coo([0, 0, 0, 1, 1], [1, 1, 2, 2, 2], 4))
    zoo.append(from_coo(rng.integers(0, 30, 97), rng.integers(0, 30, 97),
                        30))
    return zoo


@pytest.mark.parametrize("gi", [1, 3, 5])
def test_halo_plan_invariants(gi):
    g = _graph_zoo()[gi]
    mesh = make_mesh((4,), ("edge",), device="cpu")
    hg = halo.halo_graph(g, mesh)
    he = halo.halo_ell(hg, mesh)
    p, n_per, m = hg.num_parts, hg.n_per, hg.halo
    eid, dst_loc = hg.eid.numpy(), hg.dst_loc.numpy()
    dst_all = g.dst.numpy()
    seen = []
    for s in range(p):
        sel = eid[s] < g.num_edges_padded
        seen.append(eid[s][sel])
        dsts = dst_all[eid[s][sel]]
        assert (dsts // n_per == s).all()
        assert (dst_loc[s][sel] == dsts - s * n_per).all()
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)),
                                  np.arange(g.n_edges))
    send_idx, recv_pos = hg.send_idx.numpy(), he.recv_pos.numpy()
    for r in range(p):
        for s in range(p):
            for mm in range(m):
                v = send_idx[r, s, mm]
                if v < n_per:
                    assert recv_pos[r, v, s] == s * m + mm
    assert (recv_pos <= p * m).all()
