"""The sorted segment sum on S3's CSR entry (``csr_sum``) and the segment
ops built on it, against ``index_add_`` and the JAX package.

- ``csr_sum``'s plain version (what runs on the CPU; the CUDA kernel is
  held to it on the card by ``chip_smoke.py``) against ``index_add_`` over
  the same segments, at 1e-5: both sum f32 rows, in other orders;
- the segment ops, ``gspmm``'s copy and binary forms, ``gsddmm`` and the
  segment GAT attention, forward and gradients, against JAX's at
  ``impl="xla"`` within 1e-5 (f32 gathers and sums in other orders), on a
  graph with a hub node (an edge to and from every node), two nodes with
  no edge (empty segments) and a padded edge tail (ids ``n``, which the
  sums drop and the gathers clamp to row ``n - 1``, as JAX's do).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_op_benchmark_tpu import ops as jops
from custom_op_benchmark_tpu.graph import from_coo as jax_from_coo
from custom_op_benchmark_tpu_torch import ops as tops
from custom_op_benchmark_tpu_torch.graph import from_coo
from custom_op_benchmark_tpu_torch.ops import xla
from custom_op_benchmark_tpu_torch.ops.kernels.gather_sum import (
    csr_sum,
    csr_sum_plain,
)

TOL = dict(rtol=1e-5, atol=1e-5)
N = 40


def _hub_edges(seed=0):
    """Node 0 sends to and receives from every node but the last two,
    which have no edge at all; random edges among the rest."""
    rng = np.random.default_rng(seed)
    real = np.arange(1, N - 2)
    src = [np.zeros(len(real), np.int64), real]
    dst = [real, np.zeros(len(real), np.int64)]
    m = rng.random((N - 2, N - 2)) < 0.1
    s, d = np.nonzero(m)
    src.append(s[s > 0])
    dst.append(d[s > 0])
    return np.concatenate(src), np.concatenate(dst)


@pytest.fixture(scope="module", params=[None, 64], ids=["unpadded", "pad64"])
def graphs(request):
    src, dst = _hub_edges()
    return (jax_from_coo(src, dst, N, pad_multiple=request.param),
            from_coo(src, dst, N, pad_multiple=request.param))


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _check(jfn, tfn, args, *, cot_seed=99):
    """Forward and the VJP of one random cotangent, both packages."""
    jout, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    cot = _normal(cot_seed, *jout.shape)
    jgrads = vjp(jnp.asarray(cot))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    tout = tfn(*ts)
    tout.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    for t, j in zip(ts, jgrads):
        got = torch.zeros_like(t) if t.grad is None else t.grad
        np.testing.assert_allclose(got.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("idx_kind", ["identity", "permutation", "repeats"])
@pytest.mark.parametrize("width", [(), (1,), (3, 5)])
def test_csr_sum_plain_matches_index_add(idx_kind, width):
    """Empty rows, a hub row of 300 slots, and (with ``repeats``) slots
    naming rows outside x, which add zero."""
    rng = np.random.default_rng(1)
    lengths = np.array([0, 3, 300, 0, 1, 7, 0, 2, 64, 5])
    ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    e = int(ptr[-1])
    n_x = e if idx_kind != "repeats" else 50
    x = rng.normal(size=(n_x,) + width).astype(np.float32)
    if idx_kind == "identity":
        idx = None
        rows = np.arange(e)
    elif idx_kind == "permutation":
        idx = rng.permutation(e).astype(np.int32)
        rows = idx
    else:
        idx = rng.integers(0, n_x + 3, size=e).astype(np.int32)
        rows = idx
    got = csr_sum(torch.from_numpy(ptr), torch.from_numpy(x),
                  None if idx is None else torch.from_numpy(idx))
    assert torch.equal(got, csr_sum_plain(
        torch.from_numpy(ptr), torch.from_numpy(x),
        None if idx is None else torch.from_numpy(idx)))
    seg = np.repeat(np.arange(len(lengths)), lengths)
    keep = rows < n_x
    xz = torch.from_numpy(x)[torch.from_numpy(rows[keep]).long()]
    want = torch.zeros((len(lengths),) + width).index_add_(
        0, torch.from_numpy(seg[keep]), xz)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    assert not got[lengths == 0].any()


def test_csr_sum_rounds_bf16_once():
    """bf16 rows sum in f32 and round once: equal to the f32 sum rounded."""
    rng = np.random.default_rng(2)
    ptr = torch.tensor([0, 5, 5, 40], dtype=torch.int32)
    x = torch.from_numpy(rng.normal(size=(40, 8)).astype(np.float32))
    xb = x.bfloat16()
    got = csr_sum(ptr, xb)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, csr_sum(ptr, xb.float()).bfloat16())


def test_segment_sum_takes_sorted_ids_only():
    vals = torch.ones(4, 2)
    with pytest.raises(ValueError, match="sorted"):
        xla.segment_sum(vals, torch.tensor([0, 2, 1, 3]), 4)
    out = xla.segment_sum(vals, torch.tensor([0, 0, 2, 4]), 4)
    assert out[:, 0].tolist() == [2.0, 0.0, 1.0, 0.0]


@pytest.mark.parametrize("op", ["sddmm", "softmax_src", "softmax_dst",
                                "vector_spmm"])
def test_segment_ops_on_hub_empty_and_padded_rows(graphs, op):
    jg, g = graphs
    e = g.num_edges_padded
    if op == "sddmm":
        _check(lambda a, b: jops.sddmm(jg, a, b, impl="xla"),
               lambda a, b: tops.sddmm(g, a, b, impl="xla"),
               [_normal(1, N, 2, 8), _normal(2, N, 2, 8)])
    elif op.startswith("softmax"):
        by = op.split("_")[1]
        _check(lambda s: jops.edge_softmax(jg, s, by=by, impl="xla"),
               lambda s: tops.edge_softmax(g, s, by=by, impl="xla"),
               [_normal(3, e, 2)])
    else:
        _check(lambda w, x: jops.vector_spmm(jg, w, x, impl="xla"),
               lambda w, x: tops.vector_spmm(g, w, x, impl="xla"),
               [_normal(4, e, 2), _normal(5, N, 2, 8)])


GSPMM_CASES = {
    # name: (op, lhs target, rhs target or None, to)
    "copy_u_to_dst": ("copy_lhs", "u", None, "dst"),
    "copy_v_to_src": ("copy_lhs", "v", None, "src"),
    "copy_u_to_src": ("copy_lhs", "u", None, "src"),
    "copy_e_to_src": ("copy_lhs", "e", None, "src"),
    "copy_e_to_dst": ("copy_lhs", "e", None, "dst"),
    "mul_e_v_to_src": ("mul", "e", "v", "src"),
    "add_u_v_to_dst": ("add", "u", "v", "dst"),
}


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("case", sorted(GSPMM_CASES))
def test_gspmm_matches_jax(graphs, case, reduce):
    jg, g = graphs
    op, lt, rt, to = GSPMM_CASES[case]
    rows = {"u": N, "v": N, "e": g.num_edges_padded}
    args = [_normal(6, rows[lt], 8)]
    kw = dict(lhs_target=lt)
    if rt is not None:
        args.append(_normal(7, rows[rt], 8))
        kw["rhs_target"] = rt

    def jfn(*a):
        return jops.gspmm(jg, op, reduce, *a, to=to, **kw)

    def tfn(*a):
        return tops.gspmm(g, op, reduce, *a, to=to, **kw)

    _check(jfn, tfn, args)


@pytest.mark.parametrize("op", ["dot", "copy_lhs", "sub"])
def test_gsddmm_gradients_fold_padded_edges_like_jax(graphs, op):
    """Cotangents on padded edges reach row n - 1, where the clamp took
    them from, as in JAX."""
    jg, g = graphs
    _check(lambda a, b: jops.gsddmm(jg, op, a, b),
           lambda a, b: tops.gsddmm(g, op, a, b),
           [_normal(8, N, 4), _normal(9, N, 4)])


def test_gat_attention_segment_path_matches_jax(graphs):
    jg, g = graphs
    _check(lambda al, ar, z: jops.gat_attention(jg, al, ar, z, impl="xla"),
           lambda al, ar, z: tops.gat_attention(g, al, ar, z, impl="xla"),
           [_normal(10, 2, 8), _normal(11, 2, 8), _normal(12, N, 2, 8)])

