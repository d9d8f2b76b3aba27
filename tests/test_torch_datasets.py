"""The port's dataset loaders against the JAX package's
(tests/test_datasets.py) on the committed OGB fixture: every array the
loaders give equals JAX's (the graph's canonical arrays, features, labels
and masks), the .npz converter round-trips, a Planetoid-style .npz loads,
and a GCN trains on the fixture."""

import os

import numpy as np
import pytest

from custom_op_benchmark_tpu.data import datasets as jax_datasets
from custom_op_benchmark_tpu_torch.data.datasets import (
    convert_ogb_dir,
    is_ogb_dir,
    load_dataset,
    load_ogb_dir,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "ogb_toy")


def _assert_equal_to_jax(ds, jds):
    for f in ("features", "labels", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(ds, f), getattr(jds, f),
                                      err_msg=f)
    assert (ds.num_classes, ds.name) == (jds.num_classes, jds.name)
    for f in ("src", "dst", "indptr_r", "csc_perm", "indptr_c"):
        np.testing.assert_array_equal(getattr(ds.graph, f).numpy(),
                                      np.asarray(getattr(jds.graph, f)),
                                      err_msg=f)
    assert ds.graph.n_edges == jds.graph.n_edges


def test_fixture_is_ogb_dir():
    assert is_ogb_dir(FIXTURE)


def test_load_ogb_dir():
    ds = load_ogb_dir(FIXTURE)
    assert ds.graph.n_nodes == 24
    assert ds.features.shape == (24, 6)
    assert ds.num_classes == 3
    assert ds.graph.n_edges == 172      # symmetrised and deduplicated
    assert ds.train_mask.sum() == 14
    assert ds.val_mask.sum() == 5
    assert ds.test_mask.sum() == 5
    assert not (ds.train_mask & ds.val_mask).any()
    _assert_equal_to_jax(ds, jax_datasets.load_ogb_dir(FIXTURE))


def test_convert_roundtrip(tmp_path):
    out = str(tmp_path / "toy.npz")
    convert_ogb_dir(FIXTURE, out)
    ds1, ds2 = load_ogb_dir(FIXTURE), load_dataset(out)
    assert ds2.graph.n_nodes == ds1.graph.n_nodes
    assert ds2.graph.n_edges == ds1.graph.n_edges
    np.testing.assert_allclose(ds2.features, ds1.features, rtol=1e-6)
    np.testing.assert_array_equal(ds2.labels, ds1.labels)
    np.testing.assert_array_equal(ds2.train_mask, ds1.train_mask)
    jout = str(tmp_path / "toy_jax.npz")
    jax_datasets.convert_ogb_dir(FIXTURE, jout)
    z, jz = np.load(out), np.load(jout)
    assert sorted(z.files) == sorted(jz.files)
    for k in z.files:
        np.testing.assert_array_equal(z[k], jz[k], err_msg=k)


def test_load_dataset_sniffs_dir():
    ds = load_dataset(FIXTURE)
    assert ds.name == "ogb_toy"
    assert ds.graph.n_nodes == 24
    _assert_equal_to_jax(ds, jax_datasets.load_dataset(FIXTURE))


@pytest.mark.parametrize("layout", ["adjacency", "edge_index"])
def test_planetoid_style_npz(tmp_path, layout):
    import scipy.sparse as sp

    rng = np.random.default_rng(0)
    n = 12
    adj = sp.random(n, n, density=0.3, random_state=0, format="csr")
    path = str(tmp_path / "cora_like.npz")
    feats = rng.normal(size=(n, 4)).astype(np.float32)
    labels = (np.arange(n) % 3).astype(np.int64)
    if layout == "adjacency":
        np.savez(path, adj_data=adj.data, adj_indices=adj.indices,
                 adj_indptr=adj.indptr, features=feats, labels=labels)
    else:
        coo = adj.tocoo()
        np.savez(path, edge_index=np.stack([coo.row, coo.col]),
                 features=feats, labels=labels)
    ds = load_dataset(path)
    if layout == "adjacency":
        assert ds.graph.n_nodes == n
    assert ds.graph.n_edges == adj.nnz
    assert ds.num_classes == 3
    _assert_equal_to_jax(ds, jax_datasets.load_dataset(path))


def test_training_on_real_file():
    """The --data path: a GCN trains to fit on the fixture."""
    from custom_op_benchmark_tpu_torch.models import GCN
    from custom_op_benchmark_tpu_torch.train import fit_full_graph

    ds = load_dataset(FIXTURE)
    model = GCN(hidden_dim=16, out_dim=ds.num_classes, num_layers=2,
                in_dim=ds.features.shape[1])
    _, metrics = fit_full_graph(model, ds, epochs=60, seed=0, device="cpu")
    assert metrics["val_acc"] > 0.5, metrics
