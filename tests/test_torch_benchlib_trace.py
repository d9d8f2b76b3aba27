"""The port's profiler helper and timing options (utils/benchlib.py).

``device_summary`` is held to hand-computed unions of made-up device spans
(overlap, nesting, gaps, none; host events ignored), ``trace_fn`` writes a
Chrome trace that loads as JSON and names the op it ran (on the CPU, with
no device events: the idle share is None), ``bench_fn``'s ``iters="auto"``
follows its doubling rule on a fake clock, and ``rotate`` makes copies that
share no storage and cycles the calls over them. A CPU run times nothing:
``bench_fn`` still raises on CPU tensors.
"""

import inspect
import json
import os
from types import SimpleNamespace

import pytest
import torch

from custom_op_benchmark_tpu_torch.utils import benchlib

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def fake_prof(*events):
    """A profiler stand-in whose ``events()`` are ``(name, start µs, end
    µs, device type)`` tuples; a name ending in ``#step`` is a span that
    annotates kernels on the device's timeline."""
    evs = [SimpleNamespace(name=n, device_type=t,
                           time_range=SimpleNamespace(start=s, end=e),
                           is_user_annotation=n.endswith("#step"))
           for n, s, e, t in events]
    return SimpleNamespace(events=lambda: evs)


@pytest.mark.parametrize("events, busy, window, per_name", [
    # Gaps: two kernels apart.
    ((("a", 0, 10, CUDA), ("b", 20, 30, CUDA)), 20, 30,
     {"a": (10, 1), "b": (10, 1)}),
    # Overlap: b adds only what a did not cover.
    ((("a", 0, 10, CUDA), ("b", 5, 15, CUDA)), 15, 15,
     {"a": (10, 1), "b": (5, 1)}),
    # Nesting: b inside a adds nothing; a later a adds its own span.
    ((("a", 0, 20, CUDA), ("b", 5, 10, CUDA), ("a", 30, 35, CUDA)), 25, 35,
     {"a": (25, 2), "b": (0, 1)}),
    # Host events do not count, however long.
    ((("aten::mm", 0, 100, CPU), ("k", 40, 50, CUDA)), 10, 10,
     {"k": (10, 1)}),
    # Nor does a device-side annotation around kernels and their gaps.
    ((("Optimizer.step#step", 0, 30, CUDA), ("k", 2, 6, CUDA),
      ("k", 20, 28, CUDA)), 12, 26, {"k": (12, 2)}),
])
def test_device_summary_span_union(events, busy, window, per_name):
    s = benchlib.device_summary(fake_prof(*events))
    assert s["busy_ms"] == pytest.approx(busy / 1e3)
    assert s["window_ms"] == pytest.approx(window / 1e3)
    assert s["idle_share"] == pytest.approx(1 - busy / window)
    assert s["events"] == sum(t == CUDA and not n.endswith("#step")
                              for n, *_, t in events)
    got = {k["name"]: (k["ms"] * 1e3, k["count"]) for k in s["top"]}
    assert got == pytest.approx(per_name)
    assert [k["ms"] for k in s["top"]] == sorted(
        (k["ms"] for k in s["top"]), reverse=True)
    assert sum(k["share"] for k in s["top"]) <= 1 + 1e-12


def test_device_summary_without_device_events():
    s = benchlib.device_summary(fake_prof(("aten::add", 0, 5, CPU)))
    assert s == dict(busy_ms=None, window_ms=None, idle_share=None,
                     events=0, top=[])


def test_device_summary_top_is_cut_and_shares_sum_below_one():
    events = [(f"k{i % 5}", 3 * i, 3 * i + 4, CUDA) for i in range(40)]
    s = benchlib.device_summary(fake_prof(*events), top=3)
    assert len(s["top"]) == 3
    assert sum(k["share"] for k in s["top"]) < 1
    full = benchlib.device_summary(fake_prof(*events), top=10)
    assert sum(k["share"] for k in full["top"]) == pytest.approx(1)


def test_trace_fn_on_the_cpu(tmp_path):
    """The trace holds the recorded step's calls, not the warm-up's."""
    a = torch.randn(32, 32)
    calls = []

    def fn(a):
        calls.append(1)
        return a @ a

    out = benchlib.trace_fn(fn, (a,), str(tmp_path / "t"), iters=2)
    assert out == str(tmp_path / "t")
    with open(os.path.join(out, "trace.json")) as f:
        trace = json.load(f)
    names = [ev.get("name") for ev in trace["traceEvents"]]
    assert len(calls) == 3 and names.count("aten::mm") == 2
    summary = benchlib.read_summary(out)
    assert summary["idle_share"] is None and summary["top"] == []
    assert summary["iters"] == 2 and summary["device"] == "cpu"


def test_auto_calls_doubles_until_the_window_is_long_enough():
    seen = []

    def window_s(k):        # a fake clock: 1.5 ms a call
        seen.append(k)
        return 1.5e-3 * k

    assert benchlib.auto_calls(window_s) == 16
    assert seen == [1, 2, 4, 8, 16]
    assert benchlib.auto_calls(lambda k: 1.0) == 1
    assert benchlib.auto_calls(lambda k: 0.0) == benchlib.AUTO_MAX_CALLS
    assert benchlib.auto_calls(lambda k: 0.0, max_calls=100) == 100


def test_rotate_copies_share_no_storage():
    x, y = torch.randn(8, 4), torch.randn(3).requires_grad_()
    args = (x, [y, 2], {"w": x[1:]}, "label")
    sets = benchlib.rotated_args(args, 3)
    assert len(sets) == 3 and sets[0] is args
    ptrs = set()
    for s in sets:
        tensors = (s[0], s[1][0], s[2]["w"])
        assert torch.equal(tensors[0], x) and torch.equal(tensors[1], y)
        assert s[1][1] == 2 and s[3] == "label"
        assert tensors[1].requires_grad
        ptrs.add(s[0].untyped_storage().data_ptr())
        ptrs.add(s[1][0].untyped_storage().data_ptr())
    assert len(ptrs) == 6
    for a, b in ((sets[1][2]["w"], sets[1][0]), (sets[2][2]["w"],
                                                  sets[2][0])):
        assert a.untyped_storage().data_ptr() != b.untyped_storage(
        ).data_ptr()
    with pytest.raises(ValueError):
        benchlib.rotated_args(args, 0)


def test_bench_fn_auto_and_rotate_cycle_the_copies(monkeypatch):
    """On a faked card: ``iters="auto"`` picks the count its clock gives,
    and the calls go through the R copies in turn."""
    windows = []

    def fake_time_cuda(fn, *, warmup, iters, repeats, device):
        for _ in range(warmup + iters * repeats):
            fn()
        windows.append(iters)
        return [2e-3] * repeats          # 2 ms a call

    monkeypatch.setattr(benchlib, "time_cuda", fake_time_cuda)
    monkeypatch.setattr(benchlib, "_device_of",
                        lambda args: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "fake")
    seen = []
    x = torch.zeros(4)
    rec = benchlib.bench_fn(lambda t: seen.append(t.data_ptr()), (x,),
                            iters="auto", warmup=1, repeats=2, rotate=3)
    assert windows == [1, 2, 4, 8, 16, 16]   # 8 calls: 16 ms < 20 ms
    assert rec.extra == {"iters": 16, "rotate": 3}
    assert rec.time_s == pytest.approx(2e-3)
    assert len(set(seen)) == 3
    assert all(seen[i] != seen[i + 1] for i in range(len(seen) - 1))
    assert all(seen[i] == seen[i % 3] for i in range(len(seen)))


def test_bench_fn_defaults_unchanged_and_cpu_raises():
    params = inspect.signature(benchlib.bench_fn).parameters
    assert {k: params[k].default for k in
            ("warmup", "iters", "repeats", "rotate")} == dict(
        warmup=3, iters=10, repeats=5, rotate=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        benchlib.bench_fn(lambda x: x, (torch.zeros(2),), iters="auto",
                          rotate=2)
