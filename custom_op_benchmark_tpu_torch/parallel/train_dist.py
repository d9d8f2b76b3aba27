"""Edge-partitioned distributed training: GAT and graph transformer.

Counterpart of custom_op_benchmark_tpu/parallel/train_dist.py. The
models are plain modules with replicated parameters whose attention runs
a distributed plan: the halo plan with per-shard ELL sweeps
(``(HaloGraph, HaloEll)``, what :func:`fit_edge_partitioned` uses by
default), the halo plan's segment form (a ``HaloGraph``) or the gather
plan (a ``DistGraph``). Node features and labels are sharded over the
mesh's ``"edge"`` axis; projections, LayerNorm, residuals and the MLP are
node-local.

On the local mesh the whole loss is computed in one process and autograd
gives the gradient of the global loss. On the process mesh each rank
backpropagates its rows' share of the global loss (the exchanges' VJPs
carry the cross-shard terms) and the replicated parameters' gradients are
summed over ranks in rank order (all_gather, then an ordered sum), never
by the library's own all-reduce.

``torch.optim.Adam`` stands for ``optax.adam`` (the same defaults). The
parameter layout is JAX's (``x @ W``), so :func:`dist_params_from_jax`
loads the reference's parameter dicts as they are.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from custom_op_benchmark_tpu_torch.parallel.mesh import (
    Mesh,
    global_sum,
    psum_grads,
)

# The layout picker's weight of one exchanged row against one gathered
# row: the card's row-gather rate over its link rate. The gather rate is
# S3's rate for rows that hit L2, measured on NVIDIA H100 80GB HBM3 at
# 700.00 W with S3 itself on an L2-resident table (chip_smoke.py prints
# that figure beside ``utils.benchlib.l2_gather_rate``, the probe kernel's):
# a shard's node table at the products configuration (~31k rows of 256 B)
# fits the 50 MB L2. It is kept as measured: the plans depend on it.
# The link rate is NVLink 4's published 450 GB/s a direction on the H100
# SXM (900 GB/s both directions).
ROW_GATHER_BYTES_PER_S = 7285.6e9
NVLINK_BYTES_PER_S = 450e9
COMM_WEIGHT = ROW_GATHER_BYTES_PER_S / NVLINK_BYTES_PER_S

# Steps of a run left out of the median step time (warm-up).
WARMUP_STEPS = 3


def _normal(gen, shape, fan_in, device=None):
    w = torch.randn(shape, generator=gen) / math.sqrt(fan_in)
    return nn.Parameter(w.to(device))


class DistGAT(nn.Module):
    """Replicated GAT parameters: per layer ``wq``, ``wk``, ``wv`` (d_in,
    hidden), and the output head ``wo`` (hidden, classes)."""

    def __init__(self, in_dim: int, hidden: int, num_classes: int,
                 num_heads: int = 4, num_layers: int = 2, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, hidden // num_heads
        gen = generator or torch.Generator().manual_seed(0)
        self.layers = nn.ModuleList()
        d_in = in_dim
        for _ in range(num_layers):
            self.layers.append(nn.ParameterDict({
                k: _normal(gen, (d_in, hidden), d_in)
                for k in ("wq", "wk", "wv")}))
            d_in = hidden
        self.wo = _normal(gen, (hidden, num_classes), hidden)


class DistTransformer(nn.Module):
    """Replicated graph-transformer parameters (pre-LN blocks): ``proj_in``,
    per layer LayerNorm scales/biases, ``wq/wk/wv/wo`` and the MLP, then
    the final LayerNorm and ``wo_head``."""

    def __init__(self, in_dim: int, dim: int, num_classes: int,
                 num_heads: int = 4, num_layers: int = 2,
                 mlp_dim: Optional[int] = None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        mlp_dim = mlp_dim or 4 * dim
        self.num_heads, self.head_dim = num_heads, dim // num_heads
        gen = generator or torch.Generator().manual_seed(0)
        self.proj_in = _normal(gen, (in_dim, dim), in_dim)
        self.layers = nn.ModuleList()
        for _ in range(num_layers):
            p = {"ln1s": torch.ones(dim), "ln1b": torch.zeros(dim)}
            for k in ("wq", "wk", "wv", "wo"):
                p[k] = _normal(gen, (dim, dim), dim)
            p.update(ln2s=torch.ones(dim), ln2b=torch.zeros(dim),
                     w1=_normal(gen, (dim, mlp_dim), dim),
                     b1=torch.zeros(mlp_dim),
                     w2=_normal(gen, (mlp_dim, dim), mlp_dim),
                     b2=torch.zeros(dim))
            self.layers.append(nn.ParameterDict(
                {k: v if isinstance(v, nn.Parameter) else nn.Parameter(v)
                 for k, v in p.items()}))
        self.lnos = nn.Parameter(torch.ones(dim))
        self.lnob = nn.Parameter(torch.zeros(dim))
        self.wo_head = _normal(gen, (dim, num_classes), dim)


def init_dist_gat(seed: int, in_dim: int, hidden: int, num_classes: int,
                  num_heads: int = 4, num_layers: int = 2) -> DistGAT:
    """A :class:`DistGAT` drawn from ``seed`` (the port's generator, not
    JAX's PRNG: load JAX's weights with :func:`dist_params_from_jax`)."""
    return DistGAT(in_dim, hidden, num_classes, num_heads, num_layers,
                   generator=torch.Generator().manual_seed(seed))


def init_dist_transformer(seed: int, in_dim: int, dim: int,
                          num_classes: int, num_heads: int = 4,
                          num_layers: int = 2,
                          mlp_dim: Optional[int] = None) -> DistTransformer:
    return DistTransformer(in_dim, dim, num_classes, num_heads, num_layers,
                           mlp_dim,
                           generator=torch.Generator().manual_seed(seed))


def dist_params_from_jax(params: Mapping) -> nn.Module:
    """The JAX package's ``init_dist_gat`` / ``init_dist_transformer`` dict
    (arrays as numpy) as the port's module, parameter for parameter."""
    layers = params["layers"]
    h = int(params["num_heads"])
    if "proj_in" in params:
        dim = params["proj_in"].shape[1]
        mod = DistTransformer(params["proj_in"].shape[0], dim,
                              params["wo_head"].shape[1], h, len(layers),
                              layers[0]["w1"].shape[1])
    else:
        hidden = params["wo"].shape[0]
        mod = DistGAT(layers[0]["wq"].shape[0], hidden,
                      params["wo"].shape[1], h, len(layers))
    with torch.no_grad():
        for name, p in mod.named_parameters():
            node = params
            for part in name.split("."):
                node = node[int(part)] if part.isdigit() else node[part]
            p.copy_(torch.from_numpy(np.array(node, np.float32)))
    return mod


def _cast(a, dt):
    return a if dt is None else a.to(dt)


def _attention(dg, mesh):
    from custom_op_benchmark_tpu_torch.parallel.halo import (
        HaloGraph,
        halo_attention_ell,
        halo_gat_attention,
    )
    from custom_op_benchmark_tpu_torch.parallel.shard_ops import (
        dist_gat_attention,
    )

    if isinstance(dg, tuple):            # (HaloGraph, HaloEll)
        hgr, he = dg
        return lambda q, k, v: halo_attention_ell(hgr, he, mesh, q, k, v)
    if isinstance(dg, HaloGraph):
        return lambda q, k, v: halo_gat_attention(dg, mesh, q, k, v)
    return lambda q, k, v: dist_gat_attention(dg, mesh, q, k, v)


def dist_gat_forward(dg, mesh: Mesh, params: DistGAT, x, dtype=None):
    """x: ``(n_pad, f)`` node-sharded → logits ``(n_pad, classes)``.

    ``dtype=torch.bfloat16`` runs the mixed-precision policy: parameters
    stay f32, q/k/v (so both halo exchanges) and activations are bf16,
    the logits f32.
    """
    h, d = params.num_heads, params.head_dim
    npad = x.shape[0]
    attn = _attention(dg, mesh)
    for layer in params.layers:
        xc = _cast(x, dtype)
        q = (xc @ _cast(layer["wq"], dtype)).reshape(npad, h, d)
        k = (xc @ _cast(layer["wk"], dtype)).reshape(npad, h, d)
        v = (xc @ _cast(layer["wv"], dtype)).reshape(npad, h, d)
        x = F.elu(attn(q, k, v).reshape(npad, h * d))
    return x.float() @ params.wo


def _ln(x, s, b):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + 1e-6) * s + b


def dist_transformer_forward(dg, mesh: Mesh, params: DistTransformer, x,
                             dtype=None):
    """The distributed masked graph transformer (pre-LN attention and MLP
    blocks); under ``dtype=torch.bfloat16`` the residual stream and
    LayerNorm stay f32, the projections, MLP and exchanges run bf16."""
    h, d = params.num_heads, params.head_dim
    npad = x.shape[0]
    attn = _attention(dg, mesh)
    x = x @ params.proj_in
    for lyr in params.layers:
        y = _cast(_ln(x, lyr["ln1s"], lyr["ln1b"]), dtype)
        q = (y @ _cast(lyr["wq"], dtype)).reshape(npad, h, d)
        k = (y @ _cast(lyr["wk"], dtype)).reshape(npad, h, d)
        v = (y @ _cast(lyr["wv"], dtype)).reshape(npad, h, d)
        a = attn(q, k, v).reshape(npad, h * d).float()
        x = x + a @ lyr["wo"]
        y = _cast(_ln(x, lyr["ln2s"], lyr["ln2b"]), dtype)
        mlp = F.gelu(y @ _cast(lyr["w1"], dtype) + _cast(lyr["b1"], dtype),
                     approximate="tanh") @ _cast(lyr["w2"], dtype)
        x = x + mlp.float() + lyr["b2"]
    x = _ln(x, params.lnos, params.lnob)
    return x @ params.wo_head


def _pick_order(g, p, details: Optional[dict] = None):
    """Cluster or degree-balanced renumbering, from the two host plans'
    static numbers (no device touched).

    Cost of a candidate, in gathered rows: the largest shard's padded slots
    (both packings) plus the exchange's padded rows weighted by
    :data:`COMM_WEIGHT`, the card's row-gather rate over its link rate
    (both terms move the same row bytes, and forward and backward pay each
    the same number of times). With ``details`` (a dict) each candidate's
    stats, cost and host seconds are recorded."""
    from custom_op_benchmark_tpu_torch.graph import (
        degree_balanced_order,
        reorder_graph,
    )
    from custom_op_benchmark_tpu_torch.graph.cluster import cluster_order
    from custom_op_benchmark_tpu_torch.parallel.halo import plan_stats

    best = None
    for name, make in (("cluster", cluster_order),
                       ("balanced", degree_balanced_order)):
        t0 = time.perf_counter()
        ro = make(g, p)
        t1 = time.perf_counter()
        g2, _ = reorder_graph(g, ro)
        src = g2.src.cpu().numpy()[: g2.n_edges]
        dst = g2.dst.cpu().numpy()[: g2.n_edges]
        st = plan_stats(src, dst, g2.n_nodes, g2.n_edges, p,
                        -(-g2.n_nodes // p), g2.num_edges_padded,
                        hub_threshold="auto")
        vol_rows = p * st.halo + (p - 1) * st.n_hub
        cost = st.pack_slots + COMM_WEIGHT * vol_rows
        if details is not None:
            details[name] = dict(
                order_s=t1 - t0, plan_stats_s=time.perf_counter() - t1,
                halo=st.halo, n_hub=st.n_hub, pack_slots=st.pack_slots,
                interior_frac=st.interior_frac,
                halo_fraction=st.halo_fraction, cost=cost)
        if best is None or cost < best[0]:
            best = (cost, ro, name)
    if details is not None:
        details["picked"] = best[2]
    return best[1]


@dataclasses.dataclass
class DistLayout:
    """A dataset laid out for a distributed plan: the plan (``dg``: a
    ``(HaloGraph, HaloEll)`` pair or a ``DistGraph``), the sharded node
    arrays, the graph in the plan's numbering and its renumbering (None
    for the gather plan), and ``info``: the host seconds of each step and
    the plan's numbers."""

    dg: object
    x: torch.Tensor
    labels: torch.Tensor
    train_mask: torch.Tensor
    val_mask: torch.Tensor
    graph: object
    reordering: object
    info: dict


def build_plan(dataset, mesh: Mesh, *, plan: str = "halo",
               order: str = "auto", cache_dir: Optional[str] = None,
               axis: str = "edge") -> DistLayout:
    """The distributed layout of ``dataset`` on ``mesh``: the halo plan
    renumbers the nodes first and splits hubs with ``hub_threshold=
    "auto"``, as the reference. With ``cache_dir`` the host steps (order,
    plan, packing) load from an on-disk cache when they were built before
    (graph/cache.py)."""
    from custom_op_benchmark_tpu_torch.graph import (
        degree_balanced_order,
        reorder_graph,
    )
    from custom_op_benchmark_tpu_torch.graph.cache import cached
    from custom_op_benchmark_tpu_torch.graph.cluster import cluster_order
    from custom_op_benchmark_tpu_torch.parallel.halo import (
        halo_ell_host,
        halo_plan_host,
        place_ell,
        place_halo,
        plan_summary,
        shard_halo_nodes,
    )
    from custom_op_benchmark_tpu_torch.parallel.shard_ops import (
        dist_graph,
        shard_nodes,
    )

    g = dataset.graph
    ro = None
    feats = np.asarray(dataset.features, np.float32)
    labels = np.asarray(dataset.labels, np.int32)
    train = np.asarray(dataset.train_mask, np.float32)
    val = np.asarray(dataset.val_mask, np.float32)
    p = mesh.shape[axis]
    info = {"plan": plan}
    use = dict(cache_dir=cache_dir, enable=cache_dir is not None)

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        info[key + "_s"] = time.perf_counter() - t0
        return out

    if plan == "halo":
        details = {}
        makers = {"balanced": degree_balanced_order,
                  "cluster": cluster_order}
        if order == "auto":
            ro = timed("order", lambda: cached(
                g, "pick_order", lambda: _pick_order(g, p, details),
                params=f"p={p}:w={COMM_WEIGHT:.6g}", **use))
            info["order_details"] = details
        elif order in makers:
            ro = timed("order", lambda: cached(
                g, f"order_{order}", lambda: makers[order](g, p),
                params=f"p={p}", **use))
        else:
            raise ValueError(f"order must be 'auto'/'balanced'/'cluster', "
                             f"got {order!r}")
        info["order"] = order
        g, _ = timed("reorder", lambda: reorder_graph(g, ro))

        def scatter(arr):
            out = np.zeros((ro.n_new,) + arr.shape[1:], arr.dtype)
            out[ro.perm] = arr
            return out

        feats, labels, train, val = (scatter(a) for a in (feats, labels,
                                                          train, val))
        host = timed("halo_graph", lambda: cached(
            g, "halo_plan", lambda: halo_plan_host(g, p,
                                                   hub_threshold="auto"),
            params=f"p={p}:hub=auto", **use))
        eh = timed("halo_ell", lambda: cached(
            g, "halo_ell", lambda: halo_ell_host(host),
            params=f"p={p}:hub=auto", **use))
        hgr = place_halo(host, mesh, axis)
        he = place_ell(eh, mesh, axis)
        dg = (hgr, he)
        info.update(plan_summary(hgr, he))

        def shard_fn(a):
            return shard_halo_nodes(hgr, mesh, a)
    elif plan == "gather":
        dg = timed("dist_graph", lambda: dist_graph(g, mesh, axis))

        def shard_fn(a):
            return shard_nodes(dg, mesh, a)
    else:
        raise ValueError(f"plan must be 'halo'/'gather', got {plan!r}")
    return DistLayout(dg=dg, x=shard_fn(feats),
                      labels=shard_fn(labels).long(),
                      train_mask=shard_fn(train), val_mask=shard_fn(val),
                      graph=g, reordering=ro, info=info)


def fit_edge_partitioned(dataset, mesh: Mesh, *, hidden: int = 64,
                         num_heads: int = 4, num_layers: int = 2,
                         epochs: int = 50, learning_rate: float = 1e-2,
                         seed: int = 0, plan: str = "halo",
                         arch: str = "gat", order: str = "auto",
                         dtype=None,
                         init_params: Optional[Mapping] = None,
                         cache_dir: Optional[str] = None):
    """Train a distributed GAT or graph transformer on ``dataset`` over
    ``mesh``'s ``"edge"`` axis.

    ``plan``: ``"halo"`` (owner-computes all_to_all exchange, per-shard
    ELL sweeps) or ``"gather"`` (all_gather and psum_scatter). ``arch``:
    ``"gat"`` or ``"transformer"``. ``dtype``: None (f32) or
    ``torch.bfloat16`` (parameters and optimizer state stay f32).
    ``order`` (halo plan): ``"cluster"``, ``"balanced"`` or ``"auto"``
    (both host plans built, the cheaper kept, :func:`_pick_order`).
    ``init_params``: the JAX package's parameter dict to start from
    (default: drawn from ``seed``). ``cache_dir``: cache the host plan.

    Returns ``(params, metrics)``: ``loss`` (of the last step),
    ``train_acc``, ``val_acc``, ``num_devices`` as the reference, and
    ``steps``, ``step_ms`` (median on the card, CUDA events, after
    warm-up; None on the CPU), ``peak_gib`` (on the card) and ``plan``
    (host seconds and exchange numbers, :func:`build_plan`).
    """
    axis = "edge"
    lay = build_plan(dataset, mesh, plan=plan, order=order,
                     cache_dir=cache_dir, axis=axis)
    dg, x, labels = lay.dg, lay.x, lay.labels
    train_mask, val_mask = lay.train_mask, lay.val_mask
    in_dim = x.shape[-1]
    if init_params is not None:
        params = dist_params_from_jax(init_params)
    elif arch == "transformer":
        params = init_dist_transformer(seed, in_dim, hidden,
                                       dataset.num_classes, num_heads,
                                       num_layers)
    elif arch == "gat":
        params = init_dist_gat(seed, in_dim, hidden, dataset.num_classes,
                               num_heads, num_layers)
    else:
        raise ValueError(f"arch must be 'gat'/'transformer', got {arch!r}")
    forward = (dist_transformer_forward if isinstance(params,
                                                      DistTransformer)
               else dist_gat_forward)
    params.to(mesh.device)
    on_card = mesh.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(mesh.device)

    def masked_mean(vals, mask):
        den = global_sum(mesh, axis, mask.sum()).clamp(min=1.0)
        return (vals * mask).sum() / den

    def accuracy(mask):
        with torch.no_grad():
            logits = forward(dg, mesh, params, x, dtype=dtype)
            hit = (logits.argmax(-1) == labels).float()
            return float(global_sum(mesh, axis, masked_mean(hit, mask)))

    opt = torch.optim.Adam(params.parameters(), lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    loss = torch.tensor(float("inf"))
    ends = []
    for _ in range(epochs):
        opt.zero_grad(set_to_none=True)
        logits = forward(dg, mesh, params, x, dtype=dtype)
        logp = F.log_softmax(logits, -1)
        nll = -logp.gather(-1, labels[:, None])[:, 0]
        loss_local = masked_mean(nll, train_mask)
        loss_local.backward()
        prms = list(params.parameters())
        for prm, gr in zip(prms, psum_grads(mesh, axis,
                                            [p.grad for p in prms])):
            prm.grad = gr
        opt.step()
        loss = global_sum(mesh, axis, loss_local.detach())
        if on_card:
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
    step_ms = None
    if on_card and len(ends) > WARMUP_STEPS + 1:
        ends[-1].synchronize()
        tail = ends[WARMUP_STEPS:]
        step_ms = statistics.median(a.elapsed_time(b)
                                    for a, b in zip(tail, tail[1:]))
    metrics = dict(
        loss=float(loss), train_acc=accuracy(train_mask),
        val_acc=accuracy(val_mask), num_devices=int(mesh.shape[axis]),
        steps=epochs, step_ms=step_ms,
        peak_gib=(torch.cuda.max_memory_allocated(mesh.device) / 2 ** 30
                  if on_card else None),
        plan=lay.info)
    return params, metrics
