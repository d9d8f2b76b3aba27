"""A mesh of shards, on one device or over processes, and its collectives.

Counterpart of custom_op_benchmark_tpu/parallel/mesh.py. The JAX package
runs its plans over a ``jax.sharding.Mesh`` and writes the per-shard code
once inside ``shard_map``. The port has two backends behind one
interface:

- **local** (no process group): every shard lives in this process, on one
  device. A sharded array is the JAX package's global array: a tensor
  whose first dimension is ``P·rows``, viewed as ``(P, rows, ...)``. The
  axis sizes are any positive integers; one card holds all of them.
- **process** (a ``torch.distributed`` group whose size is the product of
  the axis sizes): each rank holds its own block, ``(rows, ...)``, viewed
  as ``(1, rows, ...)``. NCCL carries the collectives on cards, gloo on
  the CPU.

Per-shard code works on blocks with a leading *local-shard* dimension
``L``: ``P`` on the local backend, 1 on the process backend
(:meth:`Mesh.local_shards`). The collectives below take and return such
blocks along one named axis:

- :func:`all_to_all` — ``(L, P, M, ...)`` → ``(L, P, M, ...)``, block
  ``s`` of shard ``r`` lands as block ``r`` of shard ``s``;
- :func:`all_gather` — ``(L, ...)`` → ``(L, P, ...)``;
- :func:`psum`, :func:`pmax` — ``(L, ...)`` → ``(L, ...)``, the same on
  every shard;
- :func:`psum_scatter` — ``(L, P, ...)`` → ``(L, ...)``: shard ``r`` gets
  the sum over shards of their block ``r``.

A reduction is never the library's own: it is an exchange (all_to_all or
all_gather) followed by a sum over the received blocks in shard order, the
same code on both backends, so a result never depends on NCCL's or gloo's
summation order. Each collective is an ``autograd.Function`` whose
backward is the transposed collective (all_to_all ↔ reverse all_to_all,
all_gather ↔ psum_scatter, psum ↔ psum).

On a mesh of several axes the local backend keeps the other axes as views
of the same tensors: an exchange along ``"edge"`` moves every head at
once, which is what the per-head-slice exchanges of a process mesh add up
to.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.autograd import Function


class Mesh:
    """Named axes over shards, on the local or the process backend."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str],
                 device, group=None):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{len(axis_sizes)} sizes for "
                             f"{len(axis_names)} axis names")
        if any(int(s) < 1 for s in axis_sizes):
            raise ValueError(f"axis sizes must be positive: {axis_sizes}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.axis_sizes: Tuple[int, ...] = tuple(int(s) for s in axis_sizes)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.axis_sizes))
        self.device = torch.device(device)
        self.group = group
        self._groups: Dict[str, object] = {}
        self.coords: Dict[str, int] = {}
        if group is not None:
            import torch.distributed as dist

            n = int(np.prod(self.axis_sizes))
            if dist.get_world_size(group) != n:
                raise ValueError(f"the process group has "
                                 f"{dist.get_world_size(group)} ranks, the "
                                 f"mesh {n} shards")
            self.rank = dist.get_rank(group)
            coord = np.unravel_index(self.rank, self.axis_sizes)
            self.coords = {a: int(c) for a, c in zip(self.axis_names, coord)}
            self._axis_groups(dist)

    def _axis_groups(self, dist) -> None:
        """One subgroup per axis: the ranks that differ only along it. Every
        rank creates every subgroup, in the same order (new_group's rule)."""
        if len(self.axis_names) == 1:
            self._groups[self.axis_names[0]] = self.group
            return
        ranks = np.arange(int(np.prod(self.axis_sizes))).reshape(
            self.axis_sizes)
        glob = dist.get_process_group_ranks(self.group)
        for i, a in enumerate(self.axis_names):
            moved = np.moveaxis(ranks, i, -1).reshape(-1, self.axis_sizes[i])
            for row in moved:
                sub = dist.new_group([glob[r] for r in row.tolist()])
                if self.rank in row.tolist():
                    self._groups[a] = sub

    @property
    def is_local(self) -> bool:
        return self.group is None

    def local_shards(self, axis: str) -> int:
        """``L``: the shards along ``axis`` this process holds."""
        return self.shape[axis] if self.is_local else 1

    def shard_index(self, axis: str) -> int:
        """This process's coordinate along ``axis`` (process backend)."""
        if self.is_local:
            raise ValueError("a local mesh holds every shard")
        return self.coords[axis]

    def axis_group(self, axis: str):
        return self._groups[axis]

    def __repr__(self) -> str:
        kind = "local" if self.is_local else f"process rank {self.rank}"
        return f"Mesh({self.shape}, {kind}, {self.device})"


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("edge",), *, device=None,
              group=None) -> Mesh:
    """A mesh over ``axis_names``.

    Without ``group``, the local backend: ``axis_sizes`` shards (default
    one; the JAX package defaults to one shard per device, and here one
    card holds them all) on ``device``, the CUDA device unless the caller
    names another. With ``group`` (a
    ``torch.distributed`` process group, or ``True`` for the default
    group), the process backend: the sizes default to ``(world size,)``
    and must multiply to it; ``device`` defaults to this rank's card under
    NCCL and the CPU under gloo.
    """
    if group is None:
        if device is None:
            from custom_op_benchmark_tpu_torch.utils.device import (
                cuda_device,
            )

            device = cuda_device()
        return Mesh(axis_sizes or (1,), axis_names, device)
    import torch.distributed as dist

    if group is True:
        group = dist.group.WORLD
    if axis_sizes is None:
        axis_sizes = (dist.get_world_size(group),)
    if device is None:
        if dist.get_backend(group) == "nccl":
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            device = torch.device("cpu")
    return Mesh(axis_sizes, axis_names, device, group=group)


def shard(mesh: Mesh, x, spec: Sequence[Optional[str]] = ("edge",)):
    """Place a host array (numpy or tensor) under ``spec``, one mesh axis
    name or None per leading dimension, as a JAX ``PartitionSpec``. The
    local backend keeps the whole array (the global array); the process
    backend keeps this rank's block of every named dimension. Every rank
    builds the host array and keeps only its own part (the JAX package's
    ``make_array_from_callback`` route)."""
    t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) \
        else x
    if not mesh.is_local:
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            n = mesh.shape[axis]
            if t.shape[dim] % n:
                raise ValueError(f"dim {dim} of size {t.shape[dim]} does not "
                                 f"split over {n} shards of {axis!r}")
            per = t.shape[dim] // n
            t = t.narrow(dim, mesh.shard_index(axis) * per, per)
    return t.contiguous().to(mesh.device)


def shard_rows(mesh: Mesh, x, axis: str = "edge"):
    """``put_sharded`` for row-sharded arrays: rows split over ``axis``."""
    return shard(mesh, x, (axis,))


def blocks(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """A sharded array as ``(L, rows, ...)`` blocks along ``axis``."""
    n = mesh.local_shards(axis)
    return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))


def unblocks(x: torch.Tensor) -> torch.Tensor:
    """``(L, rows, ...)`` blocks back to the sharded array."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


# ---------------------------------------------------------------------------
# Raw collectives (no autograd); x carries the local-shard dimension first
# ---------------------------------------------------------------------------

class _Done:
    """A finished exchange: ``wait()`` returns its value."""

    def __init__(self, value):
        self.value = value

    def wait(self):
        return self.value


class _Pending:
    """An exchange in flight on the process backend."""

    def __init__(self, work, value):
        self.work, self.value = work, value

    def wait(self):
        self.work.wait()
        return self.value


def all_to_all_start(mesh: Mesh, axis: str, x: torch.Tensor):
    """Start an all_to_all of ``(L, P, M, ...)`` blocks; ``.wait()`` gives
    the received ``(L, P, M, ...)`` blocks. On the process backend the
    exchange runs while the caller computes (``async_op=True``)."""
    if mesh.is_local:
        return _Done(x.transpose(0, 1).contiguous())
    import torch.distributed as dist

    src = x[0].contiguous()
    out = torch.empty_like(src)
    work = dist.all_to_all_single(out, src, group=mesh.axis_group(axis),
                                  async_op=True)
    return _Pending(work, out[None])


def all_gather_start(mesh: Mesh, axis: str, x: torch.Tensor):
    """Start an all_gather of ``(L, ...)`` blocks; ``.wait()`` gives
    ``(L, P, ...)``: every shard's block, on every shard."""
    p = mesh.shape[axis]
    if mesh.is_local:
        return _Done(x[None].expand((x.shape[0],) + tuple(x.shape))
                     .contiguous())
    import torch.distributed as dist

    # The output is the blocks concatenated along a leading axis of one.
    src = x[0].contiguous()[None]
    out = torch.empty((p,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    work = dist.all_gather_into_tensor(out, src, group=mesh.axis_group(axis),
                                       async_op=True)
    return _Pending(work, out[None])


def _ordered_sum(parts: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` in index order (shard order): the same adds on
    every backend."""
    acc = parts.select(dim, 0)
    for i in range(1, parts.shape[dim]):
        acc = acc + parts.select(dim, i)
    return acc


def _ordered_max(parts: torch.Tensor, dim: int) -> torch.Tensor:
    acc = parts.select(dim, 0)
    for i in range(1, parts.shape[dim]):
        acc = torch.maximum(acc, parts.select(dim, i))
    return acc


def _psum_raw(mesh, axis, x):
    if mesh.is_local:
        s = _ordered_sum(x, 0)
        return s[None].expand_as(x).contiguous()
    return _ordered_sum(all_gather_start(mesh, axis, x).wait(), 1)


def _psum_scatter_raw(mesh, axis, x):
    # After the all_to_all, block i of shard r holds shard i's block r.
    return _ordered_sum(all_to_all_start(mesh, axis, x).wait(), 1)


def _all_gather_raw(mesh, axis, x):
    return all_gather_start(mesh, axis, x).wait()


def _all_to_all_raw(mesh, axis, x):
    return all_to_all_start(mesh, axis, x).wait()


# ---------------------------------------------------------------------------
# Differentiable collectives
# ---------------------------------------------------------------------------

class _AllToAll(Function):
    @staticmethod
    def forward(ctx, mesh, axis, x):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_to_all_raw(mesh, axis, x)

    @staticmethod
    def backward(ctx, dy):
        return None, None, _all_to_all_raw(ctx.mesh, ctx.axis,
                                           dy.contiguous())


class _AllGather(Function):
    @staticmethod
    def forward(ctx, mesh, axis, x):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_gather_raw(mesh, axis, x)

    @staticmethod
    def backward(ctx, dy):
        return None, None, _psum_scatter_raw(ctx.mesh, ctx.axis,
                                             dy.contiguous())


class _PsumScatter(Function):
    @staticmethod
    def forward(ctx, mesh, axis, x):
        ctx.mesh, ctx.axis = mesh, axis
        return _psum_scatter_raw(mesh, axis, x)

    @staticmethod
    def backward(ctx, dy):
        return None, None, _all_gather_raw(ctx.mesh, ctx.axis,
                                           dy.contiguous())


class _Psum(Function):
    @staticmethod
    def forward(ctx, mesh, axis, x):
        ctx.mesh, ctx.axis = mesh, axis
        return _psum_raw(mesh, axis, x)

    @staticmethod
    def backward(ctx, dy):
        return None, None, _psum_raw(ctx.mesh, ctx.axis, dy.contiguous())


def all_to_all(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """``(L, P, M, ...)`` → ``(L, P, M, ...)``: out[s][r] = in[r][s]."""
    return _AllToAll.apply(mesh, axis, x.contiguous())


def all_gather(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """``(L, ...)`` → ``(L, P, ...)``: every shard's block."""
    return _AllGather.apply(mesh, axis, x.contiguous())


def psum(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """``(L, ...)`` → ``(L, ...)``: the sum over the axis's shards, in
    shard order, on every shard."""
    return _Psum.apply(mesh, axis, x.contiguous())


def psum_scatter(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """``(L, P, ...)`` → ``(L, ...)``: shard r gets Σ_i (block r of shard
    i), summed in shard order."""
    return _PsumScatter.apply(mesh, axis, x.contiguous())


@torch.no_grad()
def pmax(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """``(L, ...)`` → ``(L, ...)``: the elementwise maximum over the axis's
    shards. Not differentiable: the plans use it only for a softmax's
    stability shift, which is a constant of the VJP."""
    if mesh.is_local:
        m = _ordered_max(x, 0)
        return m[None].expand_as(x).contiguous()
    return _ordered_max(_all_gather_raw(mesh, axis, x.contiguous()), 1)


def psum_grads(mesh: Mesh, axis: str, grads):
    """Gradients of replicated parameters summed over the axis's processes
    in rank order: the process mesh's data-parallel reduction. On the
    local mesh one autograd pass already summed every shard's part."""
    if mesh.is_local:
        return list(grads)
    return [psum(mesh, axis, g[None])[0] for g in grads]


def global_sum(mesh: Mesh, axis: str, s: torch.Tensor) -> torch.Tensor:
    """A per-process scalar summed over the axis's processes (in rank
    order); on the local mesh the scalar is already global."""
    if mesh.is_local:
        return s
    return psum(mesh, axis, s.reshape(1, 1))[0, 0]
