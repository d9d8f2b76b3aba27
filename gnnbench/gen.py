"""The traffic generator: a planted-partition graph with class-informative
features, drawn on the device from the seed.

A frozen copy of the port's ``data.synthetic.planted_partition``, rewritten
for the device and for a fixed amount of work: every seed gives the same
node count, the same class sizes, exactly ``undirected_edges`` distinct
node pairs (no self-pairs) and the same split sizes, in another draw. An
edge joins two nodes of one class with probability ``homophily``, else any
two. The pairs are symmetrised; ``self_loops`` adds one loop a node.
Features are a class centroid plus Gaussian noise of scale
``feature_noise``. Everything is drawn with one ``torch.Generator`` on the
device, in a few large calls.
"""

from __future__ import annotations

import dataclasses

import torch

# Candidates drawn a round, as a share above the pairs still wanted: pairs
# that repeat or join a node to itself are dropped.
OVERDRAW = 1.05


@dataclasses.dataclass
class Data:
    """The generated inputs, on the device. ``src``/``dst`` are int64 in
    the generator's order: the pairs in random order, then their reverses,
    then the loops."""

    src: torch.Tensor
    dst: torch.Tensor
    features: torch.Tensor       # (n, f) float32
    labels: torch.Tensor         # (n,) int64
    train_mask: torch.Tensor     # (n,) bool
    n_nodes: int
    num_classes: int

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])


def _pairs(gen, labels, n, classes, want, homophily, device):
    """``want`` distinct unordered pairs {u, v}, u != v, as int64 keys
    ``min·n + max`` in random order."""
    by_class = torch.argsort(labels, stable=True)
    count = torch.bincount(labels, minlength=classes)
    start = torch.cumsum(count, 0) - count
    keys = torch.empty(0, dtype=torch.int64, device=device)
    while keys.numel() < want:
        m = int((want - keys.numel()) * OVERDRAW) + 1024
        u = torch.randint(0, n, (m,), generator=gen, device=device)
        same = torch.rand(m, generator=gen, device=device) < homophily
        c = labels[u]
        pick = torch.minimum((torch.rand(m, generator=gen, device=device)
                              * count[c]).long(), count[c] - 1)
        v_same = by_class[start[c] + pick]
        v_any = torch.randint(0, n, (m,), generator=gen, device=device)
        v = torch.where(same, v_same, v_any)
        keep = u != v
        u, v = u[keep], v[keep]
        new = torch.minimum(u, v) * n + torch.maximum(u, v)
        keys = torch.unique(torch.cat([keys, new]))
    pick = torch.randperm(keys.numel(), generator=gen, device=device)[:want]
    return keys[pick]


def planted_partition(*, nodes: int, classes: int, feat_dim: int,
                      undirected_edges: int, homophily: float,
                      feature_noise: float, self_loops: bool, train: int,
                      seed: int, device) -> Data:
    """Draw one graph of the mix from ``seed`` on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n = int(nodes)
    perm = torch.randperm(n, generator=gen, device=device)
    labels = torch.arange(n, device=device)[perm] % classes
    keys = _pairs(gen, labels, n, classes, int(undirected_edges),
                  float(homophily), device)
    u, v = keys // n, keys % n
    del keys
    parts_s, parts_d = [u, v], [v, u]
    if self_loops:
        loops = torch.arange(n, device=device)
        parts_s.append(loops)
        parts_d.append(loops)
    src, dst = torch.cat(parts_s), torch.cat(parts_d)
    del u, v, parts_s, parts_d
    centroids = torch.randn(classes, feat_dim, generator=gen, device=device)
    feats = torch.randn(n, feat_dim, generator=gen, device=device)
    feats.mul_(feature_noise).add_(centroids[labels])
    order = torch.randperm(n, generator=gen, device=device)
    train_mask = torch.zeros(n, dtype=torch.bool, device=device)
    train_mask[order[:train]] = True
    return Data(src=src, dst=dst, features=feats, labels=labels,
                train_mask=train_mask, n_nodes=n, num_classes=classes)


def make(cfg: dict, mix: dict, seed: int, device) -> Data:
    """The inputs of a cell: the mix's graph at the configuration's feature
    width and class count."""
    g = mix["graph"]
    return planted_partition(
        nodes=g["nodes"], classes=cfg["model"]["out_dim"],
        feat_dim=cfg["model"]["in_dim"],
        undirected_edges=g["undirected_edges"], homophily=g["homophily"],
        feature_noise=g["feature_noise"], self_loops=g["self_loops"],
        train=g["train_nodes"], seed=seed, device=device)


def draw_weights(shapes: dict, seed: int, device) -> dict:
    """Weights for a model whose state dict has these ``{name: shape}``:
    one normal draw on the device, cut into leaves in name order, each
    scaled by 1/sqrt(its last dimension)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    # A stream of its own: the data's generator took the seed itself.
    gen.manual_seed((int(seed) * 2654435761 + 97) % (2 ** 63))
    names = sorted(shapes)
    sizes = [int(torch.Size(shapes[k]).numel()) for k in names]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for k, part in zip(names, torch.split(flat, sizes)):
        shape = torch.Size(shapes[k])
        out[k] = (part.reshape(shape) / float(shape[-1]) ** 0.5).contiguous()
    return out
