"""The port's spans (``utils/spans.py``) in a training step on the CPU.

One case per op family of the GAT and GraphSAGE paths: the full-graph GAT
and GraphSAGE on the ELL view (``ell.gat_attention``, ``ell.copy_spmm``)
and GraphSAGE on a sampled batch (``sampled.copy_spmm``). Under
``torch.profiler`` a step records one each of ``train.step``,
``train.forward``, ``train.backward`` and ``train.optimizer`` and the op's
forward and backward spans, each inside its phase; the profiler changes
no bit of the loss or the parameters; without it ``span`` builds no
``record_function``. The sampled pipeline's ``data.*`` spans show on the
producer's thread in a ``benchlib.trace_fn`` trace. ``launch``, around a
ctypes kernel launch, is an op-scope range inside the span around it. A
RevGAT step adds ``train.reversible.fwd`` / ``.bwd`` around its blocks and
``train.recompute`` around the backward's recompute, inside which every
span ends in ``.recompute``; with no profiler ``span`` is the shared
no-op there too.

On the card (marker ``chip``, skipped without a CUDA device; run with
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_spans.py``): S3's kernels, launched through
``ops/kernels/_build.call`` by ``ell_copy_spmm`` forward and backward, are
listed under their launch range, which opens inside ``ell.copy_spmm.fwd``
or ``.bwd``: the span that a profile credits their device time to.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from custom_op_benchmark_tpu_torch.data import synthetic
from custom_op_benchmark_tpu_torch.data.pipeline import prefetch
from custom_op_benchmark_tpu_torch.data.sampling import NeighborSampler
from custom_op_benchmark_tpu_torch.graph import random_graph
from custom_op_benchmark_tpu_torch.models import GAT, GraphSAGE, RevGAT
from custom_op_benchmark_tpu_torch.ops import ell_copy_spmm, ell_dual
from custom_op_benchmark_tpu_torch.train.loop import (
    create_train_state,
    make_sampled_step,
    make_train_step,
    sampled_batches,
)
from custom_op_benchmark_tpu_torch.utils import benchlib, spans

DATA = dict(num_classes=3, nodes_per_class=40, feat_dim=12, avg_degree=6,
            seed=3)
PHASES = ("train.step", "train.forward", "train.backward", "train.optimizer")
PREFIXES = ("train.", "ell.", "sampled.", "data.")


@pytest.fixture(scope="module")
def ds():
    return synthetic.planted_partition(**DATA)


def _gat_ell(ds):
    model = GAT(hidden_dim=8, out_dim=3, num_layers=3, num_heads=2,
                in_dim=12)
    return model, _full_graph(ds, model), "ell.gat_attention", 3, 3


def _sage_ell(ds):
    # The first layer aggregates the features, which take no gradient.
    model = GraphSAGE(hidden_dim=8, out_dim=3, num_layers=3, in_dim=12)
    return model, _full_graph(ds, model), "ell.copy_spmm", 3, 2


def _sage_sampled(ds):
    model = GraphSAGE(hidden_dim=8, out_dim=3, num_layers=2, in_dim=12)
    b = NeighborSampler(ds.graph, [5, 3], seed=0).sample(np.arange(16))
    step = make_sampled_step()
    args = (b.graph, torch.from_numpy(ds.features[b.node_ids]),
            torch.from_numpy(ds.labels[b.seed_ids].astype(np.int64)),
            torch.from_numpy(b.seed_mask), torch.from_numpy(b.in_cols))
    return model, lambda state: step(state, *args), "sampled.copy_spmm", 2, 1


def _full_graph(ds, model):
    step = make_train_step(apply_kwargs={"ell": ell_dual(ds.graph,
                                                         profile="train")})
    args = (ds.graph, torch.from_numpy(ds.features),
            torch.from_numpy(ds.labels), torch.from_numpy(ds.train_mask))
    return lambda state: step(state, *args)


FAMILIES = {"gat_ell": _gat_ell, "sage_ell": _sage_ell,
            "sage_sampled": _sage_sampled}


def _state(model):
    model.reset_parameters(torch.Generator().manual_seed(0))
    return create_train_state(model, learning_rate=1e-2)


def _profiled_step(ds, family):
    model, run, op, n_fwd, n_bwd = FAMILIES[family](ds)
    state = _state(model)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(state)
    found = {}
    for e in prof.events():
        if e.name.startswith(PREFIXES):
            found.setdefault(e.name, []).append(e)
    return found, op, n_fwd, n_bwd


@pytest.mark.parametrize("family", FAMILIES)
def test_step_records_each_phase_once_and_every_op_call(ds, family):
    found, op, n_fwd, n_bwd = _profiled_step(ds, family)
    assert {p: len(found.get(p, [])) for p in PHASES} == dict.fromkeys(
        PHASES, 1)
    assert len(found.get(f"{op}.fwd", [])) == n_fwd
    assert len(found.get(f"{op}.bwd", [])) == n_bwd
    assert set(found) == set(PHASES) | {f"{op}.fwd", f"{op}.bwd"}


@pytest.mark.parametrize("family", FAMILIES)
def test_op_spans_lie_inside_their_phase(ds, family):
    found, op, _, _ = _profiled_step(ds, family)

    def inside(inner, outer):
        return (outer.time_range.start <= inner.time_range.start
                and inner.time_range.end <= outer.time_range.end)

    fwd, bwd = found["train.forward"][0], found["train.backward"][0]
    assert all(inside(e, fwd) for e in found[f"{op}.fwd"])
    # Whichever thread autograd ran the backward on.
    assert all(inside(e, bwd) for e in found[f"{op}.bwd"])
    assert inside(fwd, found["train.step"][0])
    assert inside(found["train.optimizer"][0], found["train.step"][0])


@pytest.mark.parametrize("family", FAMILIES)
def test_profiler_changes_no_bits(ds, family):
    def two_steps(profiled):
        model, run, *_ = FAMILIES[family](ds)
        state = _state(model)
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]):
                losses = [run(state) for _ in range(2)]
        else:
            losses = [run(state) for _ in range(2)]
        loss = losses[-1][0] if isinstance(losses[-1], tuple) else losses[-1]
        return loss, [p.detach().clone() for p in model.parameters()]

    (l_on, p_on), (l_off, p_off) = two_steps(True), two_steps(False)
    assert torch.equal(l_on, l_off)
    assert all(torch.equal(a, b) for a, b in zip(p_on, p_off))


@pytest.mark.parametrize("family", FAMILIES)
def test_no_record_function_without_a_profiler(ds, family, monkeypatch):
    built, real = [], spans._profiler.record_function

    def spy(name, *args, **kwargs):
        # torch's optimizer builds its own ranges through the same name.
        if name.startswith(PREFIXES):
            built.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(spans._profiler, "record_function", spy)
    model, run, *_ = FAMILIES[family](ds)
    run(_state(model))
    assert built == []


def test_launch_is_an_op_range_inside_its_span():
    """``launch`` builds nothing without a profiler; under one it is an
    op-scope range (the profiler links a kernel launched outside the
    dispatcher to it, not to a user-scope span) that opens inside the span
    around it."""
    assert spans.launch("a_f32") is spans.launch("b_f32")   # the no-op
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("ell.op.fwd"):
            with spans.launch("op_f32"):
                torch.ones(2).sum()
    ev = {e.name: e for e in prof.events()}
    k, s = ev["op_f32"].time_range, ev["ell.op.fwd"].time_range
    assert ev["ell.op.fwd"].is_user_annotation
    assert not ev["op_f32"].is_user_annotation
    assert s.start <= k.start <= k.end <= s.end


def _revgat_step(ds):
    model = RevGAT(hidden_dim=4, out_dim=3, num_layers=5, num_heads=2,
                   group=2, in_dim=12)
    return model, _full_graph(ds, model)


def test_recompute_tag_builds_nothing_without_a_profiler(ds, monkeypatch):
    """Inside ``recompute`` with no profiler, ``span`` is still the shared
    no-op context and a RevGAT step builds no ``record_function``."""
    with spans.recompute():
        assert spans.span("ell.op.fwd") is spans.span("train.step")
        assert spans.span("ell.op.fwd") is spans._OFF
    built, real = [], spans._profiler.record_function

    def spy(name, *args, **kwargs):
        if name.startswith(PREFIXES):
            built.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(spans._profiler, "record_function", spy)
    model, run = _revgat_step(ds)
    run(_state(model))
    assert built == []


def test_recompute_tag_ends_at_its_context():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("ell.a.fwd"):
            with spans.recompute():
                with spans.span("ell.b.fwd"):
                    with spans.recompute():
                        with spans.span("ell.c.fwd"):
                            pass
                    with spans.span("ell.d.fwd"):
                        pass
            with spans.span("ell.e.fwd"):
                pass
    names = sorted(e.name for e in prof.events()
                   if e.name.startswith(PREFIXES))
    assert names == ["ell.a.fwd", "ell.b.fwd.recompute",
                     "ell.c.fwd.recompute", "ell.d.fwd.recompute",
                     "ell.e.fwd", "train.recompute",
                     "train.recompute.recompute"]


def test_revgat_step_records_its_recompute_inside_the_backward(ds):
    """A RevGAT step of 3 blocks of 2 groups: ``train.reversible.fwd``
    three times inside ``train.forward``, ``.bwd`` three times inside
    ``train.backward``, one ``train.recompute`` an F (six) inside a
    ``.bwd``, the attention's forward span 8 times (the model's layers)
    and 6 times with ``.recompute`` (each inside a ``train.recompute``),
    its backward span 8 times; no ``.recompute`` name anywhere else."""
    model, run = _revgat_step(ds)
    state = _state(model)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(state)
    found = {}
    for e in prof.events():
        if e.name.startswith(PREFIXES + ("revgat.",)):
            found.setdefault(e.name, []).append(e)
    counts = {k: len(v) for k, v in found.items()}
    assert counts == {
        **dict.fromkeys(PHASES, 1),
        "train.reversible.fwd": 3, "train.reversible.bwd": 3,
        "train.recompute": 6,
        "ell.gat_attention.fwd": 8, "ell.gat_attention.bwd": 8,
        "ell.gat_attention.fwd.recompute": 6,
        "revgat.norm_act.fwd": 7, "revgat.norm_act.bwd": 7,
        "revgat.norm_act.fwd.recompute": 6}

    def inside(inner, outers):
        return any(o.time_range.start <= inner.time_range.start
                   and inner.time_range.end <= o.time_range.end
                   for o in outers)

    fwd, bwd = found["train.forward"], found["train.backward"]
    assert all(inside(e, fwd) for e in found["train.reversible.fwd"])
    assert all(inside(e, bwd) for e in found["train.reversible.bwd"])
    assert all(inside(e, found["train.reversible.bwd"])
               for e in found["train.recompute"])
    for name, events in found.items():
        if name.endswith(".recompute"):
            assert all(inside(e, found["train.recompute"]) for e in events)
    assert not any(inside(e, fwd) for e in found["train.recompute"])


def test_data_spans_on_the_producer_thread(ds, tmp_path):
    """``data.sample`` and ``data.to_device`` on the prefetch thread,
    ``data.batch_wait`` on the consumer's, in one ``trace_fn`` trace that
    records every thread."""
    sampler = NeighborSampler(ds.graph, [5, 3], seed=0)
    items = prefetch(sampled_batches(sampler, np.arange(120), 8), 1,
                     device="cpu")
    next(items)

    def one(x):
        return next(items)[1].sum() + x

    out = benchlib.trace_fn(one, (torch.zeros(()),), str(tmp_path / "t"),
                            iters=6)
    with open(tmp_path / "t" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    threads = {}
    for e in events:
        if e.get("ph") == "X" and e["name"].startswith("data."):
            threads.setdefault(e["name"], set()).add(e["tid"])
    assert out == str(tmp_path / "t")
    assert set(threads) == {"data.sample", "data.to_device",
                            "data.batch_wait"}
    assert threads["data.sample"] == threads["data.to_device"]
    assert not threads["data.sample"] & threads["data.batch_wait"]
    for _ in items:
        pass


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


S3_KERNELS = ("gather_sum_kernel", "gather_combine_kernel")


@pytest.mark.chip
def test_copy_spmm_kernels_are_credited_to_their_spans(cuda):
    """Each S3 kernel of ``ell_copy_spmm`` forward and backward (a
    power-law graph, so hub rows take the combine pass too) is listed under
    a host event that opens inside exactly one of ``ell.copy_spmm.fwd`` and
    ``.bwd``: its launch range, ``gather_sum_f32``. Both spans get device
    time. A bare ctypes launch would be listed under the autograd
    Function's range, which opens before the span. Profiled as
    gnnbench/run.py's traced tail profiles, after a dropped warm-up cycle
    (the tracer links a window's first kernel to no launching event)."""
    g = random_graph(4000, 60_000, seed=5, power_law=True).to(cuda)
    se, de = ell_dual(g)
    x = torch.randn(g.n_nodes, 64, device=cuda, requires_grad=True)

    def step():
        ell_copy_spmm(de, se, x).sum().backward()
        torch.cuda.synchronize()

    step()                                          # builds the library
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        step()
        prof.step()
        step()
        step()
        prof.step()
    cpu = torch.autograd.DeviceType.CPU
    events = [e for e in prof.events() if e.device_type == cpu]
    op_spans = [e for e in events
                if e.name in ("ell.copy_spmm.fwd", "ell.copy_spmm.bwd")]
    found, credited = [], {}
    for e in events:
        ks = [k for k in e.kernels if any(n in k.name for n in S3_KERNELS)]
        if not ks:
            continue
        holders = [s.name for s in op_spans
                   if s.time_range.start <= e.time_range.start
                   <= s.time_range.end]
        found.append((e.name, holders, len(ks)))
        if e.name == "gather_sum_f32" and len(holders) == 1:
            credited[holders[0]] = (credited.get(holders[0], 0)
                                    + sum(k.duration for k in ks))
    assert all(name == "gather_sum_f32" and len(holders) == 1
               for name, holders, _ in found), found
    assert sorted(credited) == ["ell.copy_spmm.bwd", "ell.copy_spmm.fwd"], (
        found)
    assert all(us > 0 for us in credited.values()), credited
