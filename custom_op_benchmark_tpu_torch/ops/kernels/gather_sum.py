"""The ELL copy-sum S3 beside its plain version.

Counterpart of ``pallas_gather_sum`` in scripts/exp_pallas_gather.py:

- :func:`gather_sum` (S3) — ``y[nodes[r]] = Σ_k x[cols[r, k]]`` over every
  row of every bucket of a :class:`~custom_op_benchmark_tpu_torch.graph.ell.
  GatherTable`, in one launch, with the table's zero rows written as 0;
  x ``(n_x, ...)`` float32 or bfloat16, trailing dims flattened; y
  ``(n_out,) + x.shape[1:]`` in x's dtype. Given one bucket's cols ``(R, D)`` int32 instead of a
  table, it sums that bucket into rows 0..R-1 (the TPU kernel's function,
  the shape of experiments/exp_pallas_gather.py).

- :func:`csr_sum` (S3's CSR entry) — ``y[r] = Σ_{k ∈ [ptr[r], ptr[r+1])}
  x[idx[k]]`` over a CSR row range, ``idx`` optional (slot k reads row k):
  the sorted segment sum of the segment ops, the copy forms of ``gspmm``
  and the sampled copy-sum's backward, in a fixed order with no atomics.

A slot whose column is outside ``[0, n_x)`` adds zero: the ELL pad column
``n_nodes`` needs no padded row of x, the convention of S1/S2. Any R is
taken (the TPU kernel needs R % 8 == 0, its grid drops the tail), and any
width d ≥ 1.

Sums are f32 in both dtypes and rounded once to x's dtype, as the TPU
kernel sums in ``x.dtype`` with f32 accumulation: bf16 rows are widened
where they are added, never copied to f32 as a whole.

On the card a row of more than PIECE slots (``graph.ell.PIECE``, the
table engine's; csrc/ell_table.cuh) is summed in pieces of PIECE slots
whose compensated partials a second launch combines in piece order
(csrc/gather_sum.cu); the wrapper allocates their scratch with
``torch.empty``, sized from what the host knows (the table's host layout,
or the CSR entry's slot count), and reads nothing back from the card.

The wrapper runs the CUDA kernel (csrc/gather_sum.cu) on CUDA tensors and
the plain version only on CPU tensors; ``gather_sum.launches`` counts
float32 kernel launches and ``gather_sum.launches_bf16`` bfloat16 ones,
and ``csr_sum.launches`` / ``csr_sum.launches_bf16`` those of the CSR
entry.
"""

from __future__ import annotations

from typing import Union

import torch

from custom_op_benchmark_tpu_torch.graph.ell import (
    MAX_BUCKETS,
    PIECE,
    GatherTable,
    ell_launch,
    one_bucket_table,
)
from custom_op_benchmark_tpu_torch.ops.kernels._build import (
    c_ptr,
    call,
    check_cuda,
    on_cpu,
)

_INT_MAX = 2**31 - 1


def _table(cols: Union[torch.Tensor, GatherTable], x: torch.Tensor):
    if x.dim() < 1:
        raise ValueError("x must have a row axis")
    if not x.dtype.is_floating_point:
        raise ValueError(f"x must be floating point, got {x.dtype}")
    if isinstance(cols, GatherTable):
        return cols
    if cols.dim() != 2:
        raise ValueError(f"cols must be (R, D), got {tuple(cols.shape)}")
    if cols.dtype != torch.int32:
        raise ValueError(f"cols must be int32, got {cols.dtype}")
    return one_bucket_table(cols)


def gather_sum_plain(cols, x: torch.Tensor) -> torch.Tensor:
    table = _table(cols, x)
    n_x = x.shape[0]
    xz = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    parts = []
    for off, w, _, rows in table.bucket_rows():
        c = table.cols[off: off + rows * w].reshape(rows, w).long()
        c = torch.where((c >= 0) & (c < n_x), c, n_x)
        parts.append(xz[c].sum(1, dtype=torch.float32))   # (rows, ...)
    out = x.new_zeros((table.n_out,) + tuple(x.shape[1:]))
    if parts:
        out[table.nodes.long()] = torch.cat(parts).to(x.dtype)
    return out


def gather_sum(cols, x: torch.Tensor) -> torch.Tensor:
    """cols: a GatherTable, or one bucket's (R, D) int32 column ids; x:
    (n_x, ...) → y (n_out, ...): each table row's sum of the rows of x it
    names (out-of-range names add 0) in its output row, zero rows 0."""
    table = _table(cols, x)
    if on_cpu(table.cols, x):
        return gather_sum_plain(table, x)
    check_cuda(ints=(table.buckets, table.cols, table.nodes,
                     table.zero_nodes), floats=(x,), bf16=True)
    nb = table.buckets.shape[0]
    if nb > MAX_BUCKETS:
        raise ValueError(f"{nb} buckets; the kernel takes {MAX_BUCKETS}")
    trail = tuple(x.shape[1:])
    xf = x.reshape(x.shape[0], -1)
    d = xf.shape[1]
    n_rows, n_zero = table.nodes.shape[0], table.zero_nodes.shape[0]
    out = torch.empty((table.n_out, d), device=x.device, dtype=x.dtype)
    if d == 0 or n_rows + n_zero == 0:
        return out.reshape((table.n_out,) + trail)
    # The vector path moves 4 elements a lane: 16-byte f32, 8-byte bf16.
    align = 4 * x.element_size()
    vec = int(d % 4 == 0 and xf.data_ptr() % align == 0
              and out.data_ptr() % align == 0)
    units, split, pieces = ell_launch(table)
    if units > _INT_MAX:
        raise ValueError(f"{units} tasks; the kernel takes {_INT_MAX}")
    scratch = torch.empty((pieces, 2, d) if split else (0,),
                          device=x.device, dtype=torch.float32)
    call(gather_sum, "gather_sum", x, c_ptr(table.buckets), nb,
         c_ptr(table.cols), c_ptr(table.nodes), n_rows,
         c_ptr(table.zero_nodes), n_zero, c_ptr(xf), c_ptr(out), d,
         xf.shape[0], vec, c_ptr(scratch) if split else None, units, split)
    return out.reshape((table.n_out,) + trail)


gather_sum.launches = 0
gather_sum.launches_bf16 = 0


def _csr_args(ptr: torch.Tensor, x: torch.Tensor, idx):
    if x.dim() < 1 or not x.dtype.is_floating_point:
        raise ValueError(f"x must be floating point with a row axis, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if ptr.dim() != 1 or ptr.numel() < 1 or ptr.dtype != torch.int32:
        raise ValueError(f"ptr must be (n_rows + 1,) int32, got {ptr.dtype} "
                         f"{tuple(ptr.shape)}")
    if idx is not None and (idx.dim() != 1 or idx.dtype != torch.int32):
        raise ValueError(f"idx must be (E,) int32, got {idx.dtype} "
                         f"{tuple(idx.shape)}")


def csr_sum_plain(ptr: torch.Tensor, x: torch.Tensor,
                  idx: torch.Tensor = None) -> torch.Tensor:
    """The CSR sum in plain PyTorch: rows grouped by length into powers of
    two, each group gathered into ``(rows, width, ...)`` (a padded slot
    reads a zero row) and summed in f32 (f64 for f64), then rounded once
    to x's dtype. Any floating dtype (the kernel takes f32 and bf16)."""
    _csr_args(ptr, x, idx)
    n_rows, n_x = ptr.numel() - 1, x.shape[0]
    trail = tuple(x.shape[1:])
    acc = torch.promote_types(x.dtype, torch.float32)
    out = torch.zeros((n_rows,) + trail, dtype=acc, device=x.device)
    lo = ptr[:-1].long()
    length = ptr[1:].long() - lo
    if n_rows == 0 or int(length.max()) <= 0:
        return out.to(x.dtype)
    xz = torch.cat([x, x.new_zeros((1,) + trail)])
    width = torch.where(length > 0,
                        2 ** torch.ceil(torch.log2(length.clamp(min=1)
                                                   .double())).long(), 0)
    for w in torch.unique(width).tolist():
        if w == 0:
            continue
        rows = torch.nonzero(width == w)[:, 0]
        k = lo[rows, None] + torch.arange(w, device=x.device)
        valid = k < (lo + length)[rows, None]
        if idx is not None:
            k = idx[k.clamp(max=max(idx.numel() - 1, 0))].long()
        c = torch.where(valid & (k >= 0) & (k < n_x), k, n_x)
        out[rows] = xz[c].sum(1, dtype=acc)
    return out.to(x.dtype)


def csr_sum(ptr: torch.Tensor, x: torch.Tensor,
            idx: torch.Tensor = None) -> torch.Tensor:
    """ptr: (n_rows + 1,) int32 row offsets; x: (n_x, ...) float32 or
    bfloat16; idx: (E,) int32 rows of x for the slots, or None (slot k
    reads row k) → y (n_rows, ...): row r the sum over slots ptr[r] ..
    ptr[r+1]-1 (a slot naming a row outside [0, n_x) adds 0), in slot
    order, f32 sums rounded once to x's dtype. The same inputs give the
    same bits on every run."""
    _csr_args(ptr, x, idx)
    tensors = (ptr, x) if idx is None else (ptr, x, idx)
    if on_cpu(*tensors):
        return csr_sum_plain(ptr, x, idx)
    xf = x.reshape(x.shape[0], -1)
    ints = (ptr,) if idx is None else (ptr, idx)
    check_cuda(ints=ints, floats=(xf,), bf16=True)
    trail = tuple(x.shape[1:])
    n_rows, d = ptr.numel() - 1, xf.shape[1]
    out = torch.empty((n_rows, d), device=x.device, dtype=x.dtype)
    if d == 0 or n_rows == 0:
        return out.reshape((n_rows,) + trail)
    align = 4 * x.element_size()
    vec = int(d % 4 == 0 and xf.data_ptr() % align == 0
              and out.data_ptr() % align == 0)
    # Windows of PIECE slots over idx (or x's rows for identity slots):
    # two partials of d (sum, carry) each, then one int a window.
    n_slots = xf.shape[0] if idx is None else idx.numel()
    scratch = torch.empty(-(-n_slots // PIECE) * (4 * d + 1),
                          device=x.device, dtype=torch.float32)
    call(csr_sum, "csr_sum", x, c_ptr(ptr), n_rows,
         None if idx is None else c_ptr(idx), c_ptr(xf), c_ptr(out), d,
         xf.shape[0], vec, c_ptr(scratch), n_slots)
    return out.reshape((n_rows,) + trail)


csr_sum.launches = 0
csr_sum.launches_bf16 = 0
