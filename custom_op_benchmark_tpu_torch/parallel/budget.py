"""Static per-shard memory budget of the halo-partitioned training path.

Counterpart of custom_op_benchmark_tpu/parallel/budget.py without its
v5e/v5p capacity tables: arithmetic over a :class:`parallel.halo.
PlanStats` and the dtype policy, no device touched, and ``fits`` reads the
card's memory from ``torch.cuda.get_device_properties``.

Model (per shard, bytes) for an L-layer distributed GAT
(``fit_edge_partitioned(plan="halo")``):

  features        n_per · f · dt
  qkv + out       4 · n_per · h·d · dt           per live layer
  ext tables      2 · n_ext · h·d · dt           the k‖v extended tables
  α residual      pack_local · h · 4             every layer (f32)
  ell indices     2 · pack_slots · 4 + 2 · E_p · 4
  params + adam   3 · param_count · 4            replicated

``remat=True`` keeps one layer's activations live at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

HEADROOM = 0.90   # the share of the card's memory the model state may use


def card_bytes(device=None) -> int:
    """The card's memory (``torch.cuda.get_device_properties``)."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass the capacity in bytes")
    return int(torch.cuda.get_device_properties(
        device if device is not None else 0).total_memory)


@dataclasses.dataclass(frozen=True)
class ShardBudget:
    """Per-shard byte accounting; ``total`` is the peak-live estimate."""

    features: int
    layer_live: int
    alpha_residual: int
    ell_indices: int
    params_opt: int

    @property
    def total(self) -> int:
        return (self.features + self.layer_live + self.alpha_residual
                + self.ell_indices + self.params_opt)

    def fits(self, capacity_bytes: Optional[int] = None) -> bool:
        """Within ``HEADROOM`` of ``capacity_bytes`` (default: the card's
        memory)."""
        cap = card_bytes() if capacity_bytes is None else capacity_bytes
        return self.total <= cap * HEADROOM


def shard_budget(st, *, feat_dim: int, heads: int, head_dim: int,
                 num_layers: int = 2, dtype_bytes: int = 2,
                 remat: bool = True,
                 param_count: int = None) -> ShardBudget:
    """Budget one shard of the halo plan described by ``st``. ``dtype_bytes``:
    2 for the bf16 activation policy, 4 for f32. ``param_count`` defaults
    to the GAT's 3·L weight matrices at hidden = heads·head_dim and an
    output head of 256 classes."""
    p = st.num_parts
    hd = heads * head_dim
    n_ext = st.n_per + 1 + p * st.halo + p * st.n_hub
    if param_count is None:
        hidden = hd
        param_count = (feat_dim * hidden + 3 * (num_layers - 1)
                       * hidden * hidden + 2 * hidden * hidden
                       + hidden * 256)
    per_layer = (4 * st.n_per * hd * dtype_bytes
                 + 2 * n_ext * hd * dtype_bytes)
    live_layers = 1 if remat else num_layers
    alpha = num_layers * (st.pack_slots // 2) * heads * 4
    ell_idx = 2 * st.pack_slots * 4 + 2 * st.edges_per_part * 4
    return ShardBudget(
        features=st.n_per * feat_dim * dtype_bytes,
        layer_live=live_layers * per_layer,
        alpha_residual=alpha,
        ell_indices=ell_idx,
        params_opt=3 * param_count * 4,
    )


def budget_table(st_by_p: dict, *, feat_dim: int, heads: int,
                 head_dim: int, num_layers: int = 2,
                 capacity_bytes: Optional[int] = None) -> list:
    """Rows for every (P, dtype, remat) combination, each with whether a
    shard fits ``capacity_bytes`` (default: this card's memory; None in the
    rows where there is neither)."""
    if capacity_bytes is None:
        try:
            capacity_bytes = card_bytes()
        except RuntimeError:
            capacity_bytes = None
    rows = []
    for p, st in sorted(st_by_p.items()):
        for dt_name, dt in (("bf16", 2), ("f32", 4)):
            for remat in (True, False):
                b = shard_budget(st, feat_dim=feat_dim, heads=heads,
                                 head_dim=head_dim, num_layers=num_layers,
                                 dtype_bytes=dt, remat=remat)
                rows.append(dict(
                    devices=p, dtype=dt_name, remat=remat,
                    features_gb=round(b.features / 1e9, 2),
                    layer_live_gb=round(b.layer_live / 1e9, 2),
                    alpha_gb=round(b.alpha_residual / 1e9, 2),
                    ell_idx_gb=round(b.ell_indices / 1e9, 2),
                    total_gb=round(b.total / 1e9, 2),
                    fits_card=(None if capacity_bytes is None
                               else b.fits(capacity_bytes)),
                ))
    return rows
