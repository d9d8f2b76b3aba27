"""Per-process row loading of the port (``data/distributed.py``) against
the JAX package's (tests/test_distributed_data.py): on one process the
local mesh owns every row, the loader is asked once for the whole range,
a 2-D mesh takes the row range from the edge axis, and a memmap loader
round-trips. The same arrays come out of both packages."""

import numpy as np
import pytest

from custom_op_benchmark_tpu.data import distributed as jdist
from custom_op_benchmark_tpu.parallel import make_mesh as jax_make_mesh
from custom_op_benchmark_tpu_torch.data.distributed import (
    memmap_rows,
    padded_rows,
    process_row_range,
    sharded_node_array,
)
from custom_op_benchmark_tpu_torch.parallel import make_mesh


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((8,), ("edge",), device="cpu")


def test_process_row_range_covers_all(mesh):
    n = 1000
    jmesh = jax_make_mesh((8,), ("edge",))
    assert process_row_range(n, mesh) == (0, padded_rows(n, mesh, "edge"))
    assert process_row_range(n, mesh) == jdist.process_row_range(n, jmesh)
    assert padded_rows(n, mesh, "edge") == jdist.padded_rows(n, jmesh,
                                                             "edge")


def test_sharded_node_array_from_loader(mesh):
    n, d = 1000, 16
    full = np.arange(n * d, dtype=np.float32).reshape(n, d)
    calls = []

    def loader(lo, hi):
        calls.append((lo, hi))
        return full[lo:hi]

    arr = sharded_node_array(loader, n, (d,), mesh)
    n_pad = padded_rows(n, mesh, "edge")
    assert tuple(arr.shape) == (n_pad, d)
    got = arr.numpy()
    np.testing.assert_array_equal(got[:n], full)
    assert (got[n:] == 0).all()
    assert calls == [(0, n)]
    jarr = jdist.sharded_node_array(lambda a, b: full[a:b], n, (d,),
                                    jax_make_mesh((8,), ("edge",)))
    np.testing.assert_array_equal(got, np.asarray(jarr))


def test_process_row_range_2d_mesh():
    mesh2 = make_mesh((4, 2), ("edge", "head"), device="cpu")
    n = 100
    n_pad = padded_rows(n, mesh2, "edge")
    assert process_row_range(n, mesh2, "edge") == (0, n_pad) == \
        jdist.process_row_range(n, jax_make_mesh((4, 2), ("edge", "head")),
                                "edge")
    full = np.arange(n * 4, dtype=np.float32).reshape(n, 4)
    arr = sharded_node_array(lambda a, b: full[a:b], n, (4,), mesh2)
    assert tuple(arr.shape) == (n_pad, 4)
    np.testing.assert_array_equal(arr.numpy()[:n], full)


def test_memmap_loader_roundtrip(tmp_path, mesh):
    n, d = 256, 8
    full = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
    path = str(tmp_path / "feats.npy")
    np.save(path, full)
    arr = sharded_node_array(memmap_rows(path), n, (d,), mesh)
    np.testing.assert_array_equal(arr.numpy()[:n], full)
