"""On-disk datasets: format loaders and the .npz converter.

Counterpart of custom_op_benchmark_tpu/data/datasets.py, with numpy and
gzip only. Layouts:

- **canonical .npz** (``src, dst, features, labels, train_mask,
  val_mask, test_mask``; :func:`~custom_op_benchmark_tpu_torch.data.
  synthetic.from_numpy_files`), or a directory holding ``graph.npz``;
- **OGB node-property directory**: ``raw/edge.csv(.gz)``,
  ``raw/node-feat.csv(.gz)``, ``raw/node-label.csv(.gz)`` and
  ``split/<split>/{train,valid,test}.csv(.gz)``, loaded directly or
  converted to the canonical .npz by :func:`convert_ogb_dir`;
- **Planetoid-style .npz** (a CSR adjacency under ``adj_*`` keys or a COO
  ``edge_index``; features under ``features`` or ``attr_*``).

:func:`load_dataset` tells the layout from the path.
"""

from __future__ import annotations

import gzip
import os
from typing import Optional

import numpy as np

from custom_op_benchmark_tpu_torch.data.synthetic import (
    NodeClassificationDataset,
    from_numpy_files,
)
from custom_op_benchmark_tpu_torch.graph.graph import from_coo


def _read_csv_gz(path: str, dtype) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return np.loadtxt(f, delimiter=",", dtype=dtype, ndmin=2)


def _find(path: str, *names: str) -> Optional[str]:
    for name in names:
        for cand in (os.path.join(path, name),
                     os.path.join(path, name + ".gz")):
            if os.path.exists(cand):
                return cand
    return None


def is_ogb_dir(path: str) -> bool:
    return os.path.isdir(path) and _find(
        os.path.join(path, "raw"), "edge.csv") is not None


def _split_masks(n: int):
    """The deterministic 60/20/20 split used where none is published."""
    perm = np.random.default_rng(0).permutation(n)
    tr, va = int(0.6 * n), int(0.8 * n)
    masks = [np.zeros(n, bool) for _ in range(3)]
    masks[0][perm[:tr]] = True
    masks[1][perm[tr:va]] = True
    masks[2][perm[va:]] = True
    return masks


def load_ogb_dir(path: str, name: str = None,
                 undirected: bool = True) -> NodeClassificationDataset:
    """Load an extracted OGB node-property dataset directory.

    ``undirected=True`` symmetrises the edges (stored once, as OGB stores
    arxiv and products) and removes duplicates."""
    raw = os.path.join(path, "raw")
    edges = _read_csv_gz(_find(raw, "edge.csv"), np.int64)
    feats = _read_csv_gz(_find(raw, "node-feat.csv"), np.float32)
    labels = _read_csv_gz(_find(raw, "node-label.csv"), np.int64)[:, 0]
    n = feats.shape[0]
    src, dst = edges[:, 0], edges[:, 1]
    if undirected:
        src, dst = (np.concatenate([src, dst]), np.concatenate([dst, src]))
        uniq = np.unique(src * np.int64(n) + dst)
        src, dst = uniq // n, uniq % n

    split_root = os.path.join(path, "split")
    split_dir = None
    if os.path.isdir(split_root):
        subs = sorted(d for d in os.listdir(split_root)
                      if os.path.isdir(os.path.join(split_root, d)))
        if subs:
            split_dir = os.path.join(split_root, subs[0])
    if split_dir is None:
        train_mask, val_mask, test_mask = _split_masks(n)
    else:
        def _mask(split_file: Optional[str]) -> np.ndarray:
            m = np.zeros(n, bool)
            if split_file is not None:
                m[_read_csv_gz(split_file, np.int64)[:, 0]] = True
            return m

        train_mask = _mask(_find(split_dir, "train.csv"))
        val_mask = _mask(_find(split_dir, "valid.csv"))
        test_mask = _mask(_find(split_dir, "test.csv"))

    return NodeClassificationDataset(
        graph=from_coo(src, dst, n), features=feats,
        labels=labels.astype(np.int32), train_mask=train_mask,
        val_mask=val_mask, test_mask=test_mask,
        num_classes=int(labels.max()) + 1,
        name=name or os.path.basename(os.path.normpath(path)))


def convert_ogb_dir(path: str, out_npz: str) -> str:
    """OGB directory → canonical .npz (loads about 10× faster than the
    CSVs). Returns ``out_npz``."""
    ds = load_ogb_dir(path)
    e = ds.graph.n_edges
    np.savez_compressed(
        out_npz, src=ds.graph.src.cpu().numpy()[:e],
        dst=ds.graph.dst.cpu().numpy()[:e], features=ds.features,
        labels=ds.labels, train_mask=ds.train_mask, val_mask=ds.val_mask,
        test_mask=ds.test_mask)
    return out_npz


def _planetoid_npz(path: str, name: str) -> NodeClassificationDataset:
    z = np.load(path, allow_pickle=False)
    keys = set(z.files)
    if {"adj_data", "adj_indices", "adj_indptr"} <= keys:
        indptr = z["adj_indptr"]
        n = len(indptr) - 1
        src = np.repeat(np.arange(n), np.diff(indptr))
        dst = z["adj_indices"]
    elif "edge_index" in keys:
        src, dst = z["edge_index"][0], z["edge_index"][1]
        n = int(max(src.max(), dst.max())) + 1
    else:
        raise ValueError(f"unrecognized npz keys {sorted(keys)} in {path}")
    if {"attr_data", "attr_indices", "attr_indptr"} <= keys:
        fi, fd, fp = z["attr_indices"], z["attr_data"], z["attr_indptr"]
        fdim = (int(z["attr_shape"][1]) if "attr_shape" in keys
                else int(fi.max()) + 1)
        feats = np.zeros((n, fdim), np.float32)
        feats[np.repeat(np.arange(len(fp) - 1), np.diff(fp)), fi] = fd
    else:
        feats = z["features"].astype(np.float32)
    labels = z["labels"].astype(np.int32)
    train_mask, val_mask, test_mask = _split_masks(n)
    return NodeClassificationDataset(
        graph=from_coo(src, dst, n), features=feats, labels=labels,
        train_mask=train_mask, val_mask=val_mask, test_mask=test_mask,
        num_classes=int(labels.max()) + 1, name=name)


def load_dataset(path: str, name: str = None) -> NodeClassificationDataset:
    """Tell the layout from ``path`` and load it."""
    name = name or os.path.splitext(os.path.basename(
        os.path.normpath(path)))[0]
    if os.path.isdir(path):
        if is_ogb_dir(path):
            return load_ogb_dir(path, name=name)
        npz = _find(path, "graph.npz")
        if npz:
            return from_numpy_files(npz, name=name)
        raise ValueError(f"no recognizable dataset layout under {path}")
    if path.endswith(".npz"):
        z = np.load(path, allow_pickle=False)
        if {"src", "dst", "features"} <= set(z.files):
            return from_numpy_files(path, name=name)
        return _planetoid_npz(path, name)
    raise ValueError(f"unsupported dataset path {path!r}")
