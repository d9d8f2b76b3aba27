"""The GAT attention's three ELL sweeps as CUDA kernels (csrc/ell_gat.cu).

``ops/ell.py``'s ``_EllGat`` runs these on CUDA tensors; its plain torch
code (``_gat_fwd_plain``, ``_gat_bwd_plain``) runs on CPU tensors, as the
other wrappers of ``ops/kernels`` run their plain versions. Each sweep is
one call over all buckets of a packing, driven by the packing's
:class:`~custom_op_benchmark_tpu_torch.graph.ell.GatherTable`:

- :func:`gat_forward` (dst packing): ``el = z·a_l``, ``er = z·a_r``, the
  masked softmax α of ``LeakyReLU(el[u] + er[v])`` over each row's slots,
  and ``out[v] = Σ α·z[u]``;
- :func:`gat_backward_dst` (pass 1, dst packing): ``dα = <dy[v], z[u]>``,
  ``dpre = LeakyReLU'·α(dα − Σ α·dα)`` and its row sums ``der``;
- :func:`gat_backward_src` (pass 2, src packing): ``dz[u] = (der·a_r) +
  (Σ α·dy[v] + d_el·a_l)`` with ``d_el[u] = Σ dpre``, α and dpre read
  through ``twin_slot``, and ``d_a_l = Σ_n d_el·z``, ``d_a_r = Σ_n der·z``.

z is ``(n, h, d)`` float32 or bfloat16 with n the packings' node count;
every sum is f32, outputs are rounded to z's dtype where the plain version
rounds (and ``d_a_l``, ``d_a_r`` to the attention vectors' dtype). α and
dpre cross between the sweeps in the dst packing's flat slot order
(``EllGraph.table_flat`` places the dst table's slots there,
``EllGraph.table_twin`` the src table's twins). ``<sweep>.launches``
counts calls in float32 and ``<sweep>.launches_bf16`` in bfloat16.

With ``a_r`` None there is no dst term: the score is ``LeakyReLU(el[u])``
and there is no ``d_a_r``. The sweeps then take a zero ``a_r`` (so ``er``
is 0 and the dz term ``der·a_r`` adds 0) and run their instructions
unchanged; ``gat_forward`` returns ``er`` None, ``gat_backward_dst`` takes
it so, and ``<sweep>.launches_no_dst`` counts these calls in either
dtype.

How a call spreads its rows follows z's shape and the arrays' alignment
(:func:`lane_mode`): 16-byte lanes where d % 4 == 0 and the bases allow,
else whole rows a warp (the sums load all of a row piece's features for
each slot; the dot holds a head of dy in registers), which
``<sweep>.launches_whole_row`` counts in either dtype.
"""

from __future__ import annotations

import torch

from custom_op_benchmark_tpu_torch.graph.ell import EllGraph
from custom_op_benchmark_tpu_torch.ops.kernels.gather_sum import (
    MAX_BUCKETS,
    ell_launch,
)
from custom_op_benchmark_tpu_torch.ops.kernels.tiled_kernels import (
    _call,
    _check_cuda,
    _count,
    _p,
)

NODE_CHUNK = 256  # nodes a partial of d_a_l, d_a_r (csrc/ell_gat.cu)
# Whole-row sums (csrc/ell_gat.cu): the loads a lane makes a slot, the
# fewer for rows that fit them, and the most heads.
ROW_LOADS = 12
ROW_LOADS_NARROW = 4
ROW_HEADS = 32
DOT_CHUNKS = 8  # dy chunks a lane of the dot sweep holds at one float a lane


def _table_args(ell: EllGraph):
    """The table's arrays and counts as the C entry points take them, and
    (units, split rows, pieces) of its sums."""
    t = ell.gather_table
    nb = t.buckets.shape[0]
    if nb > MAX_BUCKETS:
        raise ValueError(f"{nb} buckets; the kernels take {MAX_BUCKETS}")
    _check_cuda(ints=(t.buckets, t.cols, t.nodes, t.zero_nodes))
    args = (_p(t.buckets), nb, _p(t.cols), _p(t.nodes), t.nodes.shape[0],
            _p(t.zero_nodes), t.zero_nodes.shape[0])
    return args, ell_launch(t)


def lane_mode(h: int, d: int, align: int) -> int:
    """How the sweeps spread rows of h heads of d features whose arrays
    all start at a multiple of ``align`` elements (4, 2 or 1): 4, four
    features of one head a lane as one load (d % 4 == 0, align 4); else,
    up to ROW_HEADS heads, whole rows a warp at 2 features a load (d even,
    align 2 or more) or 1; else 0, one feature a lane in 32-feature
    chunks."""
    if d % 4 == 0 and align % 4 == 0:
        return 4
    if h > ROW_HEADS:
        return 0
    return 2 if d % 2 == 0 and align % 2 == 0 else 1


def _lanes(h: int, d: int, *tensors: torch.Tensor) -> int:
    """:func:`lane_mode` for ``tensors``' bases."""
    def align(t):
        at = t.data_ptr() // t.element_size()
        return 4 if at % 4 == 0 else 2 if at % 2 == 0 else 1

    return lane_mode(h, d, min(map(align, tensors)))


def whole_row_layout(width: int, pw: int):
    """(features a lane holds, tasks a row) of a whole-row sum over rows of
    ``width`` features at ``pw`` a load, as csrc/ell_gat.cu's row_loads
    lays them out: a task covers 32·pw·loads features."""
    per = 32 * pw
    tasks = -(-width // (per * ROW_LOADS))
    need = -(-width // (tasks * per))
    loads = ROW_LOADS_NARROW if need <= ROW_LOADS_NARROW else ROW_LOADS
    return loads * pw, tasks


def _count_lanes(fn, lanes: int) -> None:
    if lanes in (1, 2):
        fn.launches_whole_row += 1


def _check(ell: EllGraph, z: torch.Tensor, *more: torch.Tensor) -> None:
    _check_cuda(floats=(z,) + more, bf16=True)
    if z.dim() != 3 or z.shape[0] != ell.n_nodes or 0 in z.shape[1:]:
        raise ValueError(f"z must be (n_nodes={ell.n_nodes}, h, d) with h, "
                         f"d > 0, got {tuple(z.shape)}")
    if ell.device != z.device:
        raise ValueError(f"the packing is on {ell.device}, z on {z.device}")
    for t in more:
        if t.shape != z.shape:
            raise ValueError(f"{tuple(t.shape)} differs from z "
                             f"{tuple(z.shape)}")


def _dst_term(a_r, a_lf: torch.Tensor):
    """(``a_r`` as the sweeps take it, whether the dst term is absent): f32
    and contiguous, or zeros shaped as a_l for None."""
    if a_r is None:
        return torch.zeros_like(a_lf), True
    return a_r.float().contiguous(), False


def gat_forward(ell: EllGraph, a_l: torch.Tensor, a_r, z: torch.Tensor,
                slope: float):
    """ell: the dst packing; a_l, a_r (h, d) (a_r None: no dst term); z
    (n, h, d) contiguous → (out (n, h, d) in z's dtype, α
    (ell.total_slots, h) f32 in the packing's flat slot order, el (n, h)
    f32, er (n, h) f32, None without a dst term)."""
    _check(ell, z)
    n, h, d = z.shape
    a_lf = a_l.float().contiguous()
    a_rf, no_dst = _dst_term(a_r, a_lf)
    targs, (units, split, pieces) = _table_args(ell)
    f32 = dict(device=z.device, dtype=torch.float32)
    out = torch.empty_like(z)
    alpha = torch.empty((ell.total_slots, h), **f32)
    el = torch.empty((n, h), **f32)
    er = torch.empty((n, h), **f32)
    scratch = torch.empty((pieces * h * d,) if split else (0,), **f32)
    lanes = _lanes(h, d, z, out, a_lf, a_rf)
    _call("ell_gat_fwd", z, *targs, _p(ell.table_flat), _p(z), _p(a_lf),
          _p(a_rf), n, h, d, slope, _p(out), _p(alpha), _p(el), _p(er),
          _p(scratch) if split else None, units, split, lanes)
    _count(gat_forward, z)
    _count_lanes(gat_forward, lanes)
    if no_dst:
        gat_forward.launches_no_dst += 1
    return out, alpha, el, None if no_dst else er


def gat_backward_dst(ell: EllGraph, z: torch.Tensor, dy: torch.Tensor,
                     alpha: torch.Tensor, el: torch.Tensor, er, slope: float):
    """Pass 1 on the dst packing ``ell``: z, dy (n, h, d) contiguous, the
    forward's α, el, er (None: no dst term) → (ad (ell.total_slots, 2h)
    f32: each slot's α then dpre in the flat slot order, der (n, h) f32)."""
    _check(ell, z, dy)
    no_dst = er is None
    if no_dst:
        er = torch.zeros_like(el)
    n, h, d = z.shape
    targs, (units, _, _) = _table_args(ell)
    f32 = dict(device=z.device, dtype=torch.float32)
    dal = torch.empty((ell.gather_table.cols.shape[0], h), **f32)
    ad = torch.empty((ell.total_slots, 2 * h), **f32)
    der = torch.empty((n, h), **f32)
    lanes = _lanes(h, d, z, dy)
    _call("ell_gat_bwd_dst", z, *targs, _p(ell.table_flat), _p(z), _p(dy),
          _p(alpha), _p(el), _p(er), n, h, d, slope, _p(dal), _p(ad),
          _p(der), units, lanes)
    _count(gat_backward_dst, z)
    _count_lanes(gat_backward_dst, lanes)
    if no_dst:
        gat_backward_dst.launches_no_dst += 1
    return ad, der


def gat_backward_src(ell_t: EllGraph, a_l: torch.Tensor, a_r,
                     z: torch.Tensor, dy: torch.Tensor, ad: torch.Tensor,
                     der: torch.Tensor):
    """Pass 2 on the src packing ``ell_t`` (from ``ell_dual``): pass 1's
    ad and der → (d_a_l, d_a_r in a_l's and a_r's dtypes, dz (n, h, d) in
    z's dtype); a_r None: no dst term, and d_a_r None."""
    _check(ell_t, z, dy)
    n, h, d = z.shape
    a_lf = a_l.float().contiguous()
    a_rf, no_dst = _dst_term(a_r, a_lf)
    targs, (units, split, pieces) = _table_args(ell_t)
    f32 = dict(device=z.device, dtype=torch.float32)
    dz = torch.empty_like(z)
    d_el = torch.empty((n, h), **f32)
    d_a = torch.empty((2, h, d), **f32)
    scratch = torch.empty((pieces * (h * d + h),) if split else (0,), **f32)
    node_scratch = torch.empty((-(-n // NODE_CHUNK) * 2 * h * d,), **f32)
    lanes = _lanes(h, d, dy, z, dz, a_lf, a_rf)
    _call("ell_gat_bwd_src", z, *targs, _p(ell_t.table_twin), _p(dy),
          _p(ad), _p(der), _p(z), _p(a_lf), _p(a_rf), n, h, d, _p(dz),
          _p(d_el), _p(d_a), _p(scratch) if split else None,
          _p(node_scratch), units, split, lanes)
    _count(gat_backward_src, z)
    _count_lanes(gat_backward_src, lanes)
    if no_dst:
        gat_backward_src.launches_no_dst += 1
        return d_a[0].to(a_l.dtype), None, dz
    return d_a[0].to(a_l.dtype), d_a[1].to(a_r.dtype), dz


for _sweep in (gat_forward, gat_backward_dst, gat_backward_src):
    _sweep.launches = _sweep.launches_bf16 = _sweep.launches_no_dst = 0
    _sweep.launches_whole_row = 0
