"""RevGAT (models/revgat.py): grouped reversible blocks of DGL's ogbn-arxiv
GAT layer, whose backward rebuilds each block's input.

On the CPU (the tier-1 run):

- the port's model against the benchmark's plain float64 reference
  (``gnnbench/reference/revgat.py``, which imports nothing of the port
  and computes each block directly) on seeded weights: logits, loss and
  every leaf's gradient, on the ELL path and on the segment path, at 2
  groups and at 3;
- 2,098,256 parameters at the published widths (5 layers, 3 heads of
  256, 2 groups, 168 in, 40 out), named as the reference reads them;
- a block's gradients (its input's and its parameters') against the same
  functions under plain autograd, which keeps every input;
- a block saves nothing for the backward but its output's groups
  (``torch.autograd.graph.saved_tensors_hooks``), and the step's other
  layers save no block's input;
- the backward's recompute of F₂ gives the forward's F₂ bit for bit, and
  the rebuilt x₂ is within a rounding of x₂;
- ``GroupCoupling.forwards`` and ``.recomputes`` read 6 and 6 a step of
  the published depth;
- the reference's operation count by hand, and the cell's span readers
  on given span times: the recompute's spans apart from the forward's,
  the attention's bound over the model's 8 calls;
- no dense-block path.

On the card (marker ``chip``, skipped without a CUDA device; run with
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_revgat.py``): the no-dst sweeps against the plain torch
path at the model's (h, d) = (3, 128) and (3, 256), f32 and bf16, on
16-byte lanes, two runs equal bit for bit; a step at the cell's widths
counts 14 no-dst forward launches (8 calls of the model, 6 recomputed)
and 8 of each backward pass; and at the cell's graph (169,343 nodes) and
widths the backward's recomputed F₂ equals the forward's bit for bit.
"""

import numpy as np
import pytest
import torch

from custom_op_benchmark_tpu_torch.graph import clique_batch, from_coo
from custom_op_benchmark_tpu_torch.graph.blockdiag import block_graph
from custom_op_benchmark_tpu_torch.models import RevGAT
from custom_op_benchmark_tpu_torch.models.revgat import GroupCoupling
from custom_op_benchmark_tpu_torch.ops import ell as ell_ops
from custom_op_benchmark_tpu_torch.ops.ell import ell_dual, ell_gat_attention
from custom_op_benchmark_tpu_torch.train import masked_cross_entropy
from custom_op_benchmark_tpu_torch.train.loop import (
    create_train_state,
    make_train_step,
)
from gnnbench import counts, gen
from gnnbench.metrics import (
    revgat_attention_step_roofline,
    revgat_backward_device_ms,
    revgat_forward_device_ms,
    revgat_recompute_device_ms,
)
from gnnbench.reference import common, gat_dgl
from gnnbench.reference import revgat as plain
from test_torch_ell_gat_kernel import SLOPE, SWEEPS, _close, _graph, _inputs

SMALL = dict(in_dim=7, hidden_dim=4, num_heads=3, num_layers=5, group=2,
             out_dim=5)
PUBLISHED = dict(in_dim=168, hidden_dim=256, num_heads=3, num_layers=5,
                 group=2, out_dim=40)
N = 60


def _build(m: dict, device="cpu") -> RevGAT:
    return RevGAT(hidden_dim=m["hidden_dim"], out_dim=m["out_dim"],
                  num_layers=m["num_layers"], num_heads=m["num_heads"],
                  group=m["group"], in_dim=m["in_dim"], device=device)


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


def _seeded(m: dict, seed: int = 7, device="cpu"):
    """The model with the benchmark's draw of weights, and the weights."""
    model = _build(m, device)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    weights = gen.draw_weights(shapes, seed, device)
    model.load_state_dict(weights)
    return model, weights


@pytest.mark.parametrize("group", [2, 3])
@pytest.mark.parametrize("path", ["ell", "segment"])
def test_model_matches_the_reference(path, group):
    """Logits, loss and every leaf's gradient against the float64 plain
    reference from the same weights, with the model in eval mode as the
    train step runs it. The port computes in f32 and rebuilds each block's
    input from its output (one more rounding): 1e-5 of the largest
    magnitude holds that through five layers and seven batch norms."""
    m = dict(SMALL, hidden_dim=2 * group, group=group)
    g, src, dst = _small_graph()
    model, weights = _seeded(m)
    model.eval()
    x, labels, mask = _inputs_of(m)
    views = {"ell": ell_dual(g, profile="train")} if path == "ell" else {}
    logits = model(g, x, **views)
    loss = masked_cross_entropy(logits, labels, mask)
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))

    params = {k: v.double().requires_grad_() for k, v in weights.items()}
    assert set(params) == set(names)
    ref = plain.forward(params, (x, src, dst), m, common.EXACT)
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
    """2,098,256: the count the OGB leaderboard gives for RevGAT, which
    holds with no a_r, a linear residual on every layer, 2 groups of 3
    heads of 128 in each block and one head at the output."""
    model = _build(PUBLISHED)
    assert sum(p.numel() for p in model.parameters()) == 2_098_256
    conv = ("W.weight", "a_l", "W_res.weight")
    want = {f"layers.{i}.{k}" for i in (0, 4) for k in conv}
    want |= {f"layers.{b}.convs.{i}.{k}" for b in (1, 2, 3) for i in (0, 1)
             for k in conv}
    want |= {f"layers.{b}.norms.{i}.{k}" for b in (1, 2, 3) for i in (0, 1)
             for k in ("weight", "bias")}
    want |= {"norm.weight", "norm.bias", "bias_last"}
    assert set(model.state_dict()) == want
    assert set(dict(model.named_parameters())) == want
    assert plain.layer_shapes(PUBLISHED) == (
        [(168, 3, 256)] + [(384, 3, 128)] * 6 + [(768, 1, 40)])


def _block_case(path: str, seed: int = 3):
    """A block of the small model, its input and the gradient of a
    weighted sum of its output."""
    g, _, _ = _small_graph()
    model, _ = _seeded(SMALL)
    block = model.layers[1]
    gen_ = torch.Generator().manual_seed(seed)
    width = SMALL["hidden_dim"] * SMALL["num_heads"]
    x = torch.randn(N, width, generator=gen_)
    dy = torch.randn(N, width, generator=gen_)
    ell = ell_dual(g, profile="train") if path == "ell" else None
    return g, block, x, dy, ell


def _direct(block, g, ell, x):
    """The block's groups under plain autograd, every input kept."""
    xs = x.chunk(block.group, 1)
    u, ys = sum(xs[1:]), []
    for i, xi in enumerate(xs):
        u = xi + block.f(i, g, ell, u)
        ys.append(u)
    return torch.cat(ys, 1)


@pytest.mark.parametrize("path", ["ell", "segment"])
def test_block_gradient_is_the_direct_gradient(path):
    """The coupling's gradients (of its input and of each parameter) equal
    plain autograd's through the same F_g, to f32's rounding of the
    rebuilt input."""
    g, block, x, dy, ell = _block_case(path)
    leaves = [x.clone().requires_grad_()] + list(block.parameters())
    got = torch.autograd.grad(block(g, leaves[0], ell=ell), leaves, dy)
    want = torch.autograd.grad(_direct(block, g, ell, leaves[0]), leaves, dy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-6 * float(b.abs().max()))
    y = block(g, x, ell=ell)
    assert torch.equal(y, _direct(block, g, ell, x).detach())


def test_a_block_saves_only_its_output():
    """Every tensor a block keeps for the backward is one of its output's
    groups: its input is not kept, nor any of its F's activations."""
    g, block, x, dy, ell = _block_case("ell")
    x.requires_grad_()
    packed = []

    def pack(t):
        packed.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = block(g, x, ell=ell)
    assert len(packed) == block.group
    assert torch.equal(torch.cat(packed, 1), y)
    (dx,) = torch.autograd.grad(y, x, dy)
    assert torch.isfinite(dx).all()


def test_the_step_keeps_no_block_input():
    """In a whole step no tensor saved for the backward shares storage
    with a block's input (the first layer's output, or the block before's
    output, which reaches the next block only)."""
    g, _, _ = _small_graph()
    model, _ = _seeded(SMALL)
    inputs = []
    hooks = [b.register_forward_pre_hook(
        lambda mod, args: inputs.append(args[1])) for b in model.layers[1:4]]
    saved = []
    x, _, _ = _inputs_of(SMALL)
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        out = model(g, x, ell=ell_dual(g, profile="train"))
    for h in hooks:
        h.remove()
    # ``inputs`` holds the block inputs, so no saved tensor can reuse
    # their memory.
    assert len(inputs) == 3 and saved

    def storage(t):
        return t.untyped_storage().data_ptr()

    assert not {storage(t) for t in saved} & {storage(t) for t in inputs}
    out.sum().backward()


def test_recompute_gives_the_forwards_f_bit_for_bit():
    """The backward's F₂(y₁) equals the forward's bit for bit (the same
    input, kept); its F₁ runs on the rebuilt x₂ = y₂ − F₂(y₁), within a
    rounding of the forward's x₂."""
    g, block, x, dy, ell = _block_case("ell")
    calls = []
    f = block.f

    def record(i, g_, ell_, u):
        out = f(i, g_, ell_, u)
        calls.append((i, u.detach().clone(), out.detach().clone(),
                      torch.is_grad_enabled()))
        return out

    block.f = record
    x.requires_grad_()
    y = block(g, x, ell=ell)
    torch.autograd.grad(y, x, dy)
    assert [(i, grad) for i, _, _, grad in calls] == [
        (0, False), (1, False), (1, True), (0, True)]
    (_, u1, f1, _), (_, v1, g1, _) = calls[1], calls[2]
    assert torch.equal(u1, v1) and torch.equal(f1, g1)
    x2, rebuilt = calls[0][1], calls[3][1]
    assert torch.equal(x2, x.detach()[:, x.shape[1] // 2:])
    scale = float(y.detach().abs().max())
    assert float((rebuilt - x2).abs().max()) <= 2.0 ** -22 * scale


def test_coupling_counts_a_step():
    """A step of the published depth evaluates each of the six F once in
    the forward and once more in the backward."""
    g, _, _ = _small_graph()
    model, _ = _seeded(SMALL)
    state = create_train_state(model, learning_rate=1e-3)
    step = make_train_step(apply_kwargs={"ell": ell_dual(g,
                                                         profile="train")})
    x, labels, mask = _inputs_of(SMALL)
    before = (GroupCoupling.forwards, GroupCoupling.recomputes)
    step(state, g, x, labels, mask)
    assert (GroupCoupling.forwards - before[0],
            GroupCoupling.recomputes - before[1]) == (6, 6)


def test_forward_flops_by_hand():
    """Each C's two products, its attention vector, score and softmax and
    weighted sum (``reference/gat_dgl``'s rules); the recompute is not
    counted. About 0.724 TFLOP at ogbn-arxiv's sizes."""
    n, e = 10, 30
    by_hand = 0.0
    for k, h, d in [(168, 3, 256)] + [(384, 3, 128)] * 6 + [(768, 1, 40)]:
        by_hand += 2 * 2 * n * k * h * d + 2 * n * h * d + 4 * e * h
        by_hand += 2 * e * h * d
    assert plain.forward_flops(PUBLISHED, n, e) == by_hand
    total = plain.forward_flops(PUBLISHED, 169_343, 2_501_829)
    assert 0.72e12 < total < 0.73e12
    assert plain.mp_counts(n, e, 3, 128) == gat_dgl.mp_counts(n, e, 3, 128)


class _Run:
    """What the readers find behind a context's probe."""

    def __init__(self):
        self.views, self.model_cfg = {"ell": None}, PUBLISHED
        self.n, self.e, self.device = 169_343, 2_501_829, "cuda"

    def step(self):
        pass

    def probe(self):
        pass


def test_span_readers_split_the_recompute():
    """Given span times a step (seconds), the forward reader sums
    ``train.forward`` and the ``.fwd`` spans, the backward reader
    ``train.backward`` and the ``.bwd`` spans, the recompute reader
    ``train.recompute`` and the ``.recompute`` spans: each span once. The
    attention's step roofline takes the 8 model calls' bound over the
    ``ell.gat_attention.fwd`` and ``.bwd`` spans alone."""
    span_s = {"train.forward": 0.001, "train.reversible.fwd": 0.002,
              "ell.gat_attention.fwd": 0.004, "train.backward": 0.0005,
              "train.reversible.bwd": 0.008, "ell.gat_attention.bwd": 0.016,
              "train.recompute": 0.032,
              "ell.gat_attention.fwd.recompute": 0.064,
              "train.optimizer": 0.1, "(none)": 0.2}
    ctx = type("Ctx", (), {})()
    ctx.span_s, ctx.on_card, ctx.probe = span_s, True, _Run().probe
    assert revgat_forward_device_ms.read(ctx) == pytest.approx(7.0)
    assert revgat_backward_device_ms.read(ctx) == pytest.approx(24.5)
    assert revgat_recompute_device_ms.read(ctx) == pytest.approx(96.0)
    shapes = [(3, 256)] + [(3, 128)] * 6 + [(1, 40)]
    bound = sum(counts.bound_s(*gat_dgl.mp_counts(169_343, 2_501_829, h,
                                                  d))[0]
                for h, d in shapes)
    assert revgat_attention_step_roofline.read(ctx) == pytest.approx(
        100.0 * bound / 0.020)
    del span_s["train.recompute"]
    assert revgat_recompute_device_ms.read(ctx) is None


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
@pytest.mark.parametrize("h, d", [(3, 128), (3, 256)])
def test_no_dst_kernels_match_the_plain_path(cuda, h, d, dtype):
    g = _graph(6, device=cuda)
    se, de = ell_dual(g, profile="train")
    z, a_l, _, dy = _inputs(h + d, g.n_nodes, h, d, dtype, cuda)
    attr = "launches_bf16" if dtype == torch.bfloat16 else "launches"
    before = [(f.launches_no_dst, getattr(f, attr), f.launches_whole_row)
              for f in SWEEPS]
    got = _no_dst_kernel(de, se, a_l, z, dy)
    after = [(f.launches_no_dst, getattr(f, attr), f.launches_whole_row)
             for f in SWEEPS]
    # d % 4 == 0: 16-byte lanes, none on whole rows.
    assert [tuple(a - b for a, b in zip(x, w))
            for w, x in zip(before, after)] == [(1, 1, 0)] * 3
    out, alphas, signs = ell_ops._gat_fwd_plain(de, a_l, None, z, SLOPE)
    d_a_l, _, dz = ell_ops._gat_bwd_plain(de, se, a_l, None, z, alphas,
                                          signs, dy, SLOPE)
    for name, x, w in zip(("out", "d_a_l", "dz"), got, (out, d_a_l, dz)):
        assert x.dtype == w.dtype and x.shape == w.shape, name
        _close(name, x, w, dtype == torch.bfloat16)
    again = _no_dst_kernel(de, se, a_l, z, dy)
    for x, y in zip(got, again):
        assert torch.equal(x, y)


@pytest.mark.chip
def test_a_step_at_the_cells_widths_counts_its_sweeps(cuda):
    g = _graph(7, device=cuda)
    ell = ell_dual(g, profile="train")
    model = _build(dict(PUBLISHED, in_dim=24), cuda)
    x = torch.randn(g.n_nodes, 24, generator=torch.Generator().manual_seed(9))
    before = [(f.launches_no_dst, f.launches, f.launches_whole_row)
              for f in SWEEPS]
    model(g, x.to(cuda), ell=ell).square().sum().backward()
    torch.cuda.synchronize()
    after = [(f.launches_no_dst, f.launches, f.launches_whole_row)
             for f in SWEEPS]
    # Forward: the 8 layers C and the 6 recomputed F; each backward pass:
    # the 8 C. All without a dst term, all on 16-byte lanes.
    assert [tuple(a - b for a, b in zip(x, w))
            for w, x in zip(before, after)] == [
        (14, 14, 0), (8, 8, 0), (8, 8, 0)]
    for p in model.parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all()


@pytest.mark.chip
def test_recompute_is_bit_for_bit_at_the_cells_size(cuda):
    """On the cell's graph (ogbn-arxiv's sizes) at the published widths,
    the backward's F₂(y₁) equals the forward's bit for bit in every block:
    the sweeps, the batch norm's passes and the GEMMs sum in a fixed
    order."""
    from gnnbench import spec

    cell = spec.cell("arxiv_revgat.ogbn_arxiv")
    data = gen.make(cell.config, cell.mix, 2 ** 31 + 25, cuda)
    g = from_coo(data.src.cpu().numpy(), data.dst.cpu().numpy(),
                 data.n_nodes).to(cuda)
    ell = ell_dual(g, profile="train")
    model, _ = _seeded(PUBLISHED, device=cuda)
    calls = []
    for block in model.layers[1:4]:
        def record(i, g_, ell_, u, f=block.f):
            out = f(i, g_, ell_, u)
            if i == 1:
                calls.append(out.detach().clone())
            return out
        block.f = record
    loss = masked_cross_entropy(model(g, data.features, ell=ell),
                                data.labels, data.train_mask)
    loss.backward()
    torch.cuda.synchronize()
    # Forward: blocks 1, 2, 3; backward: blocks 3, 2, 1.
    assert len(calls) == 6
    for fwd, again in zip(calls[:3], calls[:2:-1]):
        assert torch.equal(fwd, again)
