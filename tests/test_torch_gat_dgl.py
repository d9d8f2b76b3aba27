"""DGL's ogbn-arxiv GAT (models/gat_dgl.py) and the GAT attention with no
dst term.

On the CPU (the tier-1 run):

- the port's model against the benchmark's plain float64 reference
  (``gnnbench/reference/gat_dgl.py``, which imports nothing of the port)
  on seeded weights: logits, loss and every leaf's gradient, on the ELL
  path and on the segment path;
- 1,441,580 parameters at the published widths (3 layers, 3 heads of 250,
  168 in, 40 out), named as the reference reads them;
- ``ell_gat_attention`` with ``a_r`` None equals the op at ``a_r = 0``, bit
  for bit, in f32 and bf16, and gives no ``a_r`` cotangent;
- degrees clamped at 1: a node with no edge but its loop and a node with
  no edge at all;
- no dense-block path: the model raises there.

On the card (marker ``chip``, skipped without a CUDA device; run with
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_gat_dgl.py``): the no-dst sweeps against the plain torch
path on the same CUDA tensors at the model's (h, d) = (3, 250) (one
feature a lane) and (1, 40), in f32 and bf16, each call counted on
``.launches_no_dst``, (3, 250) on ``.launches_whole_row`` too, two runs
equal bit for bit; a 3-layer step of the model counts 3/3/3 no-dst
launches; and at the cell's widths (3 heads of 250, 40 out) a step
counts 2/2/2 whole-row launches, the output layer on 16-byte lanes.
"""

import numpy as np
import pytest
import torch

from custom_op_benchmark_tpu_torch.graph import clique_batch, from_coo
from custom_op_benchmark_tpu_torch.graph.blockdiag import block_graph
from custom_op_benchmark_tpu_torch.models import GATDGL
from custom_op_benchmark_tpu_torch.models.gat_dgl import DegreeScales
from custom_op_benchmark_tpu_torch.ops import ell as ell_ops
from custom_op_benchmark_tpu_torch.ops.ell import ell_dual, ell_gat_attention
from custom_op_benchmark_tpu_torch.train import masked_cross_entropy
from gnnbench import gen
from gnnbench.reference import common
from gnnbench.reference import gat_dgl as plain
from test_torch_ell_gat_kernel import SLOPE, SWEEPS, _close, _graph, _inputs

SMALL = dict(in_dim=7, hidden_dim=6, num_heads=3, num_layers=3, out_dim=5)
PUBLISHED = dict(in_dim=168, hidden_dim=250, num_heads=3, num_layers=3,
                 out_dim=40)
N = 60


def _build(m: dict, device="cpu") -> GATDGL:
    return GATDGL(hidden_dim=m["hidden_dim"], out_dim=m["out_dim"],
                  num_layers=m["num_layers"], num_heads=m["num_heads"],
                  in_dim=m["in_dim"], device=device)


def _small_graph(seed: int = 0, n: int = N, e: int = 400):
    """Random edges among the first n - 2 nodes and a loop on each of them;
    node n - 2 has its loop alone, node n - 1 no edge at all."""
    rng = np.random.default_rng(seed)
    loops = np.arange(n - 1)
    src = np.concatenate([rng.integers(0, n - 2, e), loops])
    dst = np.concatenate([rng.integers(0, n - 2, e), loops])
    return from_coo(src, dst, n), torch.from_numpy(src), torch.from_numpy(dst)


def _inputs_of(m: dict, seed: int = 1):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(N, m["in_dim"])).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, m["out_dim"], N))
    mask = torch.from_numpy(rng.random(N) < 0.6)
    return x, labels, mask


@pytest.mark.parametrize("path", ["ell", "segment"])
def test_model_matches_the_reference(path):
    """Logits, loss and every leaf's gradient against the float64 plain
    reference from the same weights (the benchmark's draw, batch norm's
    scale and shift and the output bias included), with the model in eval
    mode as the train step runs it. The port computes in f32: 1e-5 of the
    largest magnitude holds f32's round-off through three layers and two
    batch norms."""
    g, src, dst = _small_graph()
    model = _build(SMALL)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    weights = gen.draw_weights(shapes, 7, "cpu")
    model.load_state_dict(weights)
    model.eval()
    x, labels, mask = _inputs_of(SMALL)
    views = {"ell": ell_dual(g, profile="train")} if path == "ell" else {}
    logits = model(g, x, **views)
    loss = masked_cross_entropy(logits, labels, mask)
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))

    params = {k: v.double().requires_grad_() for k, v in weights.items()}
    assert set(params) == set(names)
    ref = plain.forward(params, (x, src, dst), SMALL, common.EXACT)
    ref_loss = common.masked_ce(ref, labels, mask)
    ref_grads = torch.autograd.grad(ref_loss, [params[k] for k in names])

    def close(got, want, what):
        want = want.detach()
        torch.testing.assert_close(got.double(), want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()),
                                   msg=what)

    close(logits, ref, "logits")
    close(loss, ref_loss, "loss")
    for k, got, want in zip(names, grads, ref_grads):
        assert float(want.abs().max()) > 0, k
        close(got, want, k)


def test_published_widths_have_the_published_parameter_count():
    """1,441,580: the count the OGB leaderboard gives for the model, which
    holds only with no a_r and a linear residual on every layer."""
    model = _build(PUBLISHED)
    assert sum(p.numel() for p in model.parameters()) == 1_441_580
    want = {f"layers.{i}.{k}" for i in range(3)
            for k in ("W.weight", "a_l", "W_res.weight")}
    want |= {f"norms.{i}.{k}" for i in range(2) for k in ("weight", "bias")}
    want.add("bias_last")
    assert set(model.state_dict()) == want
    assert set(dict(model.named_parameters())) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_no_dst_term_is_the_op_at_a_zero_a_r(dtype):
    g = _graph(3)
    se, de = ell_dual(g, profile="train")
    z, a_l, _, dy = _inputs(3, g.n_nodes, 3, 10, dtype)
    z.requires_grad_()
    a_l.requires_grad_()
    a_r = torch.zeros_like(a_l, requires_grad=True)
    out = ell_gat_attention(de, se, a_l, None, z)
    got = torch.autograd.grad(out, (a_l, z), dy)
    out0 = ell_gat_attention(de, se, a_l, a_r, z)
    want = torch.autograd.grad(out0, (a_l, z), dy)
    assert out.dtype == dtype and torch.equal(out, out0)
    for x, w in zip(got, want):
        assert x.dtype == w.dtype and torch.equal(x, w)
    # The backward gives no a_r cotangent.
    fwd, alphas, signs = ell_ops._gat_fwd_plain(de, a_l.detach(), None,
                                                z.detach(), SLOPE)
    assert torch.equal(fwd, out)
    d_a_l, d_a_r, dz = ell_ops._gat_bwd_plain(de, se, a_l.detach(), None,
                                              z.detach(), alphas, signs, dy,
                                              SLOPE)
    assert d_a_r is None
    assert torch.equal(d_a_l, got[0]) and torch.equal(dz, got[1])


@pytest.mark.parametrize("path", ["ell", "segment"])
def test_degrees_clamp_at_one(path):
    """Node n - 2 (its loop alone) and node n - 1 (no edge) both scale by
    1; the first attends to itself alone, the second to nothing, so a
    hidden layer's three terms sum to z + the residual and the residual
    alone."""
    g, _, _ = _small_graph()
    src_scale, dst_scale = DegreeScales()(g)
    deg_out = torch.bincount(g.src[: g.n_edges].long(), minlength=N)
    deg_in = torch.bincount(g.dst[: g.n_edges].long(), minlength=N)
    torch.testing.assert_close(src_scale.flatten(),
                               deg_out.clamp(min=1).float().pow(-0.5))
    torch.testing.assert_close(dst_scale.flatten(),
                               deg_in.clamp(min=1).float().pow(0.5))
    for node in (N - 2, N - 1):
        assert src_scale[node].item() == dst_scale[node].item() == 1.0
    layer = _build(SMALL).layers[0]
    x, _, _ = _inputs_of(SMALL)
    views = {"ell": ell_dual(g, profile="train")} if path == "ell" else {}
    out, scale, res = layer(g, x, **views)
    out = (out * scale).reshape(N, -1) + res
    assert torch.equal(res, layer.W_res(x))
    assert torch.equal(out[N - 1], res[N - 1])
    torch.testing.assert_close(out[N - 2], layer.W(x)[N - 2] + res[N - 2])


def test_the_scales_are_worked_out_once_a_graph():
    g, _, _ = _small_graph()
    scales = DegreeScales()
    first = scales(g)
    assert scales(g) is first
    other, _, _ = _small_graph(seed=5)
    assert scales(other) is not first


def test_no_dense_block_path():
    g = clique_batch(4, 6)
    block = block_graph(g)
    assert block is not None
    x = torch.randn(g.n_nodes, SMALL["in_dim"])
    with pytest.raises(ValueError, match="dense-block"):
        _build(SMALL)(g, x, block=block)


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _no_dst_kernel(de, se, a_l, z, dy):
    leaves = [t.detach().clone().requires_grad_() for t in (a_l, z)]
    out = ell_gat_attention(de, se, leaves[0], None, leaves[1])
    return (out,) + torch.autograd.grad(out, leaves, dy)


@pytest.mark.chip
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h, d", [(3, 250), (1, 40)])
def test_no_dst_kernels_match_the_plain_path(cuda, h, d, dtype):
    g = _graph(6, device=cuda)
    se, de = ell_dual(g, profile="train")
    z, a_l, _, dy = _inputs(h + d, g.n_nodes, h, d, dtype, cuda)
    attr = "launches_bf16" if dtype == torch.bfloat16 else "launches"
    before = [(f.launches_no_dst, getattr(f, attr)) for f in SWEEPS]
    whole = [f.launches_whole_row for f in SWEEPS]
    got = _no_dst_kernel(de, se, a_l, z, dy)
    after = [(f.launches_no_dst, getattr(f, attr)) for f in SWEEPS]
    assert [(a - b, c - e) for (b, e), (a, c) in zip(before, after)] == [
        (1, 1)] * 3
    # 250 % 4 != 0: whole rows; (1, 40): 16-byte lanes.
    assert [f.launches_whole_row - w for f, w in zip(SWEEPS, whole)] == [
        int(d % 4 != 0)] * 3
    out, alphas, signs = ell_ops._gat_fwd_plain(de, a_l, None, z, SLOPE)
    d_a_l, d_a_r, dz = ell_ops._gat_bwd_plain(de, se, a_l, None, z, alphas,
                                              signs, dy, SLOPE)
    assert d_a_r is None
    for name, x, w in zip(("out", "d_a_l", "dz"), got, (out, d_a_l, dz)):
        assert x.dtype == w.dtype and x.shape == w.shape, name
        _close(name, x, w, dtype == torch.bfloat16)
    again = _no_dst_kernel(de, se, a_l, z, dy)
    for x, y in zip(got, again):
        assert torch.equal(x, y)


@pytest.mark.chip
def test_a_dgl_gat_step_counts_its_no_dst_sweeps(cuda):
    g = _graph(7, device=cuda)
    ell = ell_dual(g, profile="train")
    model = _build(dict(SMALL, in_dim=24, hidden_dim=250), cuda)
    x = torch.randn(g.n_nodes, 24, generator=torch.Generator().manual_seed(8))
    before = [(f.launches_no_dst, f.launches) for f in SWEEPS]
    model(g, x.to(cuda), ell=ell).square().sum().backward()
    torch.cuda.synchronize()
    after = [(f.launches_no_dst, f.launches) for f in SWEEPS]
    # Three layers: a forward sweep each, and both backward passes each,
    # every one without a dst term.
    assert [(a - b, c - e) for (b, e), (a, c) in zip(before, after)] == [
        (3, 3)] * 3
    for p in model.parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all()


@pytest.mark.chip
def test_a_dgl_gat_step_at_the_cells_widths_counts_its_whole_rows(cuda):
    g = _graph(7, device=cuda)
    ell = ell_dual(g, profile="train")
    model = _build(dict(PUBLISHED, in_dim=24), cuda)
    x = torch.randn(g.n_nodes, 24, generator=torch.Generator().manual_seed(9))
    before = [(f.launches_whole_row, f.launches_no_dst) for f in SWEEPS]
    model(g, x.to(cuda), ell=ell).square().sum().backward()
    torch.cuda.synchronize()
    after = [(f.launches_whole_row, f.launches_no_dst) for f in SWEEPS]
    # The two hidden layers at (3, 250) on whole rows, the output layer at
    # (1, 40) on 16-byte lanes; all three without a dst term.
    assert [(a - b, c - e) for (b, e), (a, c) in zip(before, after)] == [
        (2, 3)] * 3
    for p in model.parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all()
