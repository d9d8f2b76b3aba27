"""Synthetic node-classification datasets.

Counterpart of custom_op_benchmark_tpu/data/synthetic.py: planted-partition
graphs with class-correlated Gaussian features stand in for the BASELINE
configs (Cora, ogbn-arxiv) at matching scales. Everything is drawn with
numpy from ``np.random.default_rng(seed)`` in the reference's order, so one
seed gives the same graph, features, labels and masks in both packages.
The arrays stay numpy; the graph is built on the host.
``from_numpy_files`` loads the same record from an .npz.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from custom_op_benchmark_tpu_torch.graph.graph import Graph, from_coo


@dataclasses.dataclass
class NodeClassificationDataset:
    graph: Graph
    features: np.ndarray          # (n, f) float32
    labels: np.ndarray            # (n,) int32
    train_mask: np.ndarray        # (n,) bool
    val_mask: np.ndarray
    test_mask: np.ndarray
    num_classes: int
    name: str = "synthetic"


def planted_partition(
    num_classes: int = 7,
    nodes_per_class: int = 300,
    feat_dim: int = 64,
    avg_degree: int = 10,
    homophily: float = 0.8,
    feature_noise: float = 1.0,
    seed: int = 0,
    train_frac: float = 0.6,
    val_frac: float = 0.2,
    pad_multiple: Optional[int] = None,
    name: str = "planted",
) -> NodeClassificationDataset:
    """A stochastic block model with class-informative features.

    Edges prefer same-class endpoints with probability ``homophily``; the
    edge set is symmetrised, given self-loops and deduplicated. Features
    are class centroids plus Gaussian noise.
    """
    rng = np.random.default_rng(seed)
    n = num_classes * nodes_per_class
    labels = np.repeat(np.arange(num_classes), nodes_per_class)
    perm = rng.permutation(n)
    labels = labels[perm].astype(np.int32)

    e = n * avg_degree
    src = rng.integers(0, n, e)
    same = rng.random(e) < homophily
    cls_nodes = [np.nonzero(labels == c)[0] for c in range(num_classes)]
    dst = rng.integers(0, n, e)
    # The same-class edges of each class in position order, as the
    # reference's per-class masks give them (one stable sort, not a pass
    # over all edges a class); the draws keep the reference's order.
    pos = np.flatnonzero(same)
    src_cls = labels[src[pos]]
    by_cls = pos[np.argsort(src_cls, kind="stable")]
    bounds = np.concatenate([[0], np.cumsum(np.bincount(
        src_cls, minlength=num_classes))])
    for c in range(num_classes):
        pick = by_cls[bounds[c]:bounds[c + 1]]
        dst[pick] = rng.choice(cls_nodes[c], size=len(pick))
    loops = np.arange(n)
    src_all = np.concatenate([src, dst, loops])
    dst_all = np.concatenate([dst, src, loops])
    uniq = np.unique(src_all.astype(np.int64) * n + dst_all)
    src_all, dst_all = uniq // n, uniq % n
    g = from_coo(src_all, dst_all, n, pad_multiple=pad_multiple)

    centroids = rng.normal(size=(num_classes, feat_dim)).astype(np.float32)
    feats = (
        centroids[labels]
        + feature_noise * rng.normal(size=(n, feat_dim)).astype(np.float32)
    ).astype(np.float32)

    order = rng.permutation(n)
    n_train = int(train_frac * n)
    n_val = int(val_frac * n)
    train_mask = np.zeros(n, bool)
    val_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    train_mask[order[:n_train]] = True
    val_mask[order[n_train: n_train + n_val]] = True
    test_mask[order[n_train + n_val:]] = True

    return NodeClassificationDataset(
        graph=g, features=feats, labels=labels, train_mask=train_mask,
        val_mask=val_mask, test_mask=test_mask, num_classes=num_classes,
        name=name)


def cora_like(seed: int = 0, **kw) -> NodeClassificationDataset:
    """Cora-scale fixture: ~2.7k nodes, 7 classes."""
    kw.setdefault("num_classes", 7)
    kw.setdefault("nodes_per_class", 387)
    kw.setdefault("feat_dim", 128)
    kw.setdefault("avg_degree", 4)
    return planted_partition(seed=seed, name="cora_like", **kw)


def arxiv_like(seed: int = 0, **kw) -> NodeClassificationDataset:
    """ogbn-arxiv-scale fixture: ~170k nodes, 40 classes."""
    kw.setdefault("num_classes", 40)
    kw.setdefault("nodes_per_class", 4243)
    kw.setdefault("feat_dim", 128)
    kw.setdefault("avg_degree", 7)
    return planted_partition(seed=seed, name="arxiv_like", **kw)


def from_numpy_files(path: str, name: str = "file") -> NodeClassificationDataset:
    """Load a dataset from an .npz with src/dst/features/labels/masks (or a
    directory holding ``graph.npz``)."""
    z = np.load(path if path.endswith(".npz")
                else os.path.join(path, "graph.npz"))
    n = int(z["features"].shape[0])
    return NodeClassificationDataset(
        graph=from_coo(z["src"], z["dst"], n),
        features=z["features"].astype(np.float32),
        labels=z["labels"].astype(np.int32),
        train_mask=z["train_mask"].astype(bool),
        val_mask=z["val_mask"].astype(bool),
        test_mask=z["test_mask"].astype(bool),
        num_classes=int(z["labels"].max()) + 1,
        name=name)
