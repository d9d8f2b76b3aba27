"""``spans.self_device_s`` on fake profiles, and the span readers without
a profile to read."""

import types

import pytest
import torch

from gnnbench import gen, spans, spec
from gnnbench.conftest import tiny_cell
from gnnbench.metrics import (
    backward_device_ms,
    ell_gat_attention_step_roofline,
    forward_device_ms,
    optimizer_device_ms,
)

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
MAIN, AUTOGRAD, PRODUCER = 1, 2, 3
LISTED = [w["name"] for w in spec.benchmark()["workloads"]]
READERS = [forward_device_ms, backward_device_ms, optimizer_device_ms,
           ell_gat_attention_step_roofline]


class Prof:
    """A profile of fake events in the fields ``self_device_s`` reads: a
    host op lists the device ops it launched in its ``kernels``, as the
    profiler lists them by correlation id."""

    def __init__(self):
        self._events = []

    def events(self):
        return self._events

    def host(self, name, t0, t1, thread):
        ev = types.SimpleNamespace(
            name=name, device_type=CPU, thread=thread, kernels=[],
            time_range=types.SimpleNamespace(start=t0, end=t1))
        self._events.append(ev)
        return ev

    def launch(self, name, t0, thread, kernel, k0, k1):
        """A host op at ``t0`` on ``thread`` and the device op it launched,
        from ``k0`` to ``k1`` µs."""
        op = self.host(name, t0, t0 + 1, thread)
        self.device(kernel, k0, k1)
        op.kernels.append(types.SimpleNamespace(name=kernel,
                                                duration=k1 - k0))

    def device(self, name, k0, k1, annotation=False):
        self._events.append(types.SimpleNamespace(
            name=name, device_type=CUDA, thread=0, kernels=[],
            time_range=types.SimpleNamespace(start=k0, end=k1),
            is_user_annotation=annotation))


@pytest.fixture
def prof():
    p = Prof()
    p.host("train.step", 0, 1000, MAIN)
    p.host("train.forward", 10, 300, MAIN)
    p.host("ell.gat_attention.fwd", 50, 100, MAIN)
    p.launch("aten::index", 60, MAIN, "gather", 1000, 1040)
    p.launch("aten::mm", 20, MAIN, "gemm", 1040, 1050)
    p.host("train.backward", 300, 800, MAIN)
    # autograd's thread: the op's backward span, and an op of its own.
    p.host("ell.gat_attention.bwd", 400, 500, AUTOGRAD)
    p.launch("aten::index", 420, AUTOGRAD, "gather", 1050, 1110)
    p.launch("aten::mm", 600, AUTOGRAD, "gemm", 1110, 1130)
    # the prefetch thread: its copy, and a sample open across the mm above.
    p.host("data.to_device", 310, 330, PRODUCER)
    p.launch("aten::copy_", 315, PRODUCER, "Memcpy HtoD", 1130, 1135)
    p.host("data.sample", 550, 700, PRODUCER)
    p.host("train.optimizer", 810, 900, MAIN)
    p.launch("aten::_foreach_add_", 820, MAIN, "adam", 1135, 1137)
    p.launch("aten::argmax", 950, MAIN, "argmax", 1137, 1138)
    p.launch("aten::add", 2000, MAIN, "add", 1138, 1140)
    p.device("unlisted", 1140, 1144)
    p.device("ell.gat_attention.fwd", 1000, 1040, annotation=True)
    return p


def test_autograd_thread_op_goes_to_its_backward_span(prof):
    got = spans.self_device_s(prof)
    assert got["ell.gat_attention.bwd"] == pytest.approx(60e-6)
    # The autograd thread's own mm, outside the op's span: the training
    # thread's train.backward, not the producer's shorter data.sample.
    assert got["train.backward"] == pytest.approx(20e-6)
    assert "data.sample" not in got


def test_other_threads_shorter_span_takes_its_copy(prof):
    got = spans.self_device_s(prof)
    assert got["data.to_device"] == pytest.approx(5e-6)


def test_op_under_no_span_or_unlisted_goes_to_none(prof):
    got = spans.self_device_s(prof)
    assert got[spans.NONE] == pytest.approx(6e-6)


def test_every_device_op_counts_once(prof):
    got = spans.self_device_s(prof)
    assert got["ell.gat_attention.fwd"] == pytest.approx(40e-6)
    assert got["train.forward"] == pytest.approx(10e-6)
    assert got["train.optimizer"] == pytest.approx(2e-6)
    assert got["train.step"] == pytest.approx(1e-6)
    # The annotation range is not an op; the rest sum to the device time.
    assert sum(got.values()) == pytest.approx(144e-6)


def _ctx(**kw):
    return types.SimpleNamespace(**dict(dict(on_card=False, probe=None),
                                        **kw))


@pytest.mark.parametrize("reader", READERS, ids=lambda m: m.__name__)
def test_readers_read_nothing_without_spans(reader):
    assert reader.read(_ctx()) is None
    assert reader.read(_ctx(on_card=True)) is None


def test_no_port_spans_no_profile(monkeypatch):
    """Where the port has no ``utils/spans.py``, nothing is profiled."""
    monkeypatch.setattr(spans, "PORT_SPANS",
                        "custom_op_benchmark_tpu_torch.utils.no_spans")
    run = types.SimpleNamespace(step=None, device=None)
    ctx = _ctx(on_card=True, probe=types.MethodType(lambda self: None, run))
    assert spans.per_step(ctx) is None


SPLIT = {"train.step": 0.5e-3, "train.forward": 10e-3,
         "ell.gat_attention.fwd": 20e-3, "train.backward": 15e-3,
         "ell.gat_attention.bwd": 40e-3, "sampled.copy_spmm.bwd": 1e-3,
         "train.optimizer": 0.2e-3, spans.NONE: 0.1e-3}
ARXIV = dict(in_dim=128, hidden_dim=128, num_heads=4, num_layers=3,
             out_dim=40)


def test_readers_split_the_step():
    ctx = _ctx(span_s=SPLIT)
    assert forward_device_ms.read(ctx) == pytest.approx(30.0)
    assert backward_device_ms.read(ctx) == pytest.approx(56.0)
    assert optimizer_device_ms.read(ctx) == pytest.approx(0.2)
    whole = sum(SPLIT.values()) * 1e3
    assert (forward_device_ms.read(ctx) + backward_device_ms.read(ctx)
            + optimizer_device_ms.read(ctx)
            + 1e3 * (SPLIT["train.step"] + SPLIT[spans.NONE])
            == pytest.approx(whole))
    assert forward_device_ms.read(_ctx(span_s={spans.NONE: 1.0})) is None


def test_step_roofline_over_the_attention_spans():
    n, e = 169343, 2501829
    run = types.SimpleNamespace(step=None, device=None, views={"ell": None},
                                model_cfg=ARXIV, n=n, e=e)
    ctx = _ctx(span_s=SPLIT, probe=types.MethodType(lambda self: None, run))
    bound = ell_gat_attention_step_roofline.mp_step_bound_s(ARXIV, n, e)
    # Two hidden layers at 0.530 ms by bytes, the output layer at 0.052.
    assert bound == pytest.approx(1.112e-3, rel=2e-3)
    assert ell_gat_attention_step_roofline.read(ctx) == pytest.approx(
        100 * bound / 60e-3)
    run.views = {"block": None}
    assert ell_gat_attention_step_roofline.read(ctx) is None


def test_per_step_profiles_the_cells_own_steps():
    """The path behind ``ctx.probe`` takes a warm-up and ``STEPS`` profiled
    steps once a run; on the CPU they launch no device op to credit."""
    cell = tiny_cell(LISTED[0])
    device = torch.device("cpu")
    data = gen.make(cell.config, cell.mix, 7, device)
    path_run = spec.path(cell.mix["path"]).Run(
        cell, data, spec.family(cell.config["family"]), 7, device)
    ctx = _ctx(on_card=True, probe=path_run.probe)
    assert spans.per_step(ctx) == {} and ctx.span_s == {}
    assert len(path_run.losses) == spans.STEPS + 1
    assert spans.per_step(ctx) == {}
    assert len(path_run.losses) == spans.STEPS + 1
    assert all(r.read(ctx) is None for r in READERS)
    path_run.close()
