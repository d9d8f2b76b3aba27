"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m gnnbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the cell's CUDA devices. In
order: the inputs and weights from ``--seed`` on the device
(``gen.py``); the port's path for the cell with its host builds, the
checked steps and the warm-up (``paths/<path>.py``), all set-up; the
window, ``--seconds`` of steps with a CUDA event after each and the card's
clocks sampled beside it; with ``--trace 1`` a short profiled tail and
the per-layer readers; the program's state freed; the check against the
plain reference (``judges/<path>.py``), each compared number beside its
limit (``limits/<workload>.json``). The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``. The compared numbers are also the last lines of standard
error. Exits 2 without the cell's CUDA devices and 3 if JAX, flax or the
JAX package was imported, printing no result line either way.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from typing import Callable, Optional  # noqa: E402

import torch  # noqa: E402

from gnnbench import gen, smi, spec, timing  # noqa: E402
from gnnbench.reference import common  # noqa: E402

IMPORTED = time.perf_counter()

FORBIDDEN = ("jax", "jaxlib", "flax", "custom_op_benchmark_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    jaxlib's, flax's or the JAX package's, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What the readers of the metrics read."""

    setup_s: float
    window_s: float
    steps: int
    step_s: list
    peak_bytes: Optional[int]
    counts: dict
    probe: Callable
    on_card: bool
    busy_per_step: Optional[float] = None


class Clock:
    """Marks after steps: CUDA events on the card, the host clock
    elsewhere (a run off the card reports no device number)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def gaps_s(self, marks: list) -> list:
        if not self.cuda:
            return [b - a for a, b in zip(marks, marks[1:])]
        marks[-1].synchronize()
        return [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]


def judge_limits(readings: dict, limits: dict) -> tuple:
    """(all within their limits, [(name, value, limit)]) for every number
    that ``limits`` names; a missing or non-finite number fails."""
    ok, rows = True, []
    for name, entry in limits["numbers"].items():
        value, limit = readings.get(name), entry["limit"]
        ok &= (value is not None and math.isfinite(value)
               and value <= limit)
        rows.append((name, value, limit))
    return ok, rows


def _traced_tail(run, clock, steps: int) -> tuple:
    """Profile ``steps`` steps after a dropped warm-up step: (the device
    summary, the host seconds of the recorded steps, the profiler)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if clock.cuda else [])
    with profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1)) as prof:
        run.step(traced=True)
        clock.sync()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(steps):
            with torch.profiler.record_function("gnnbench.step"):
                run.step(traced=True)
        clock.sync()
        wall = time.perf_counter() - t0
        prof.step()
    return timing.device_summary(prof), wall, prof


def _window(run, clock, seconds: float) -> tuple:
    """``seconds`` of steps with a mark after each, the card's clocks
    sampled beside them: (marks, start, window seconds, clocks)."""
    sampler = smi.Sampler() if clock.cuda else None
    try:
        clock.sync()
        t0 = time.perf_counter()
        marks = [clock.mark()]
        while time.perf_counter() - t0 < seconds:
            run.step()
            marks.append(clock.mark())
        clock.sync()
        window_s = time.perf_counter() - t0
    finally:
        clocks = sampler.stop() if sampler else {}
    return marks, t0, window_s, clocks


def _measure(run, cell, clock, seconds: float, trace: bool, log) -> dict:
    """The window and, with ``trace``, the profiled tail; the metrics the
    cell reports in this mode (none off the card: a time or a rate comes
    from the card)."""
    before = run.capture.snapshot()
    marks, t0, window_s, clocks = _window(run, clock, seconds)
    peak = torch.cuda.max_memory_allocated() if clock.cuda else None
    steps = len(marks) - 1
    window = common.window_readings(before, run.capture.snapshot(), steps,
                                    cell.config["optimizer"])
    del before
    ctx = Context(setup_s=t0 - START, window_s=window_s, steps=steps,
                  step_s=clock.gaps_s(marks), peak_bytes=peak,
                  counts=run.counts(steps), probe=run.probe,
                  on_card=clock.cuda)
    log(json.dumps(dict(clocks=clocks, window_s=window_s, steps=steps)))
    losses = torch.stack(run.losses).double() if run.losses else None
    out = dict(steps=steps, peak=peak, device={}, breakdown=None,
               window=window,
               failed=0 if losses is None
               else int((~torch.isfinite(losses)).sum()))
    if trace:
        steps_traced = cell.mix["trace_steps"]
        summary, wall, prof = _traced_tail(run, clock, steps_traced)
        if summary["busy_s"] is not None:
            ctx.busy_per_step = summary["busy_s"] / steps_traced
            out["device"] = dict(busy_s=summary["busy_s"], window_s=wall)
            out["breakdown"] = dict(
                device_ops=summary["top"],
                idle_gaps=timing.idle_gaps(prof, summary["gaps"]))
    out["metrics"] = {}
    wanted = cell.per_layer if trace else cell.end_to_end
    for m in wanted if clock.cuda else []:
        value = spec.metric_reader(m["name"]).read(ctx)
        if value is not None:
            out["metrics"][m["name"]] = dict(value=float(value),
                                             unit=m["unit"])
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, log=print) -> dict:
    """Run ``cell`` once on ``device`` and return its result (the line's
    keys). ``log`` takes the earlier lines."""
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, mix = cell.config, cell.mix
    family, path = spec.family(cfg["family"]), spec.path(mix["path"])
    t_in = time.perf_counter()
    data = gen.make(cfg, mix, seed, device)
    # The edges wait on the host until the check: the program gets them
    # there, and the device's peak is the program's.
    data.src, data.dst = data.src.cpu(), data.dst.cpu()
    clock = Clock(device)
    clock.sync()
    if clock.cuda:
        torch.cuda.reset_peak_memory_stats()
    t_prog = time.perf_counter()
    run = path.Run(cell, data, family, seed, device)
    try:
        clock.sync()
        setup = dict(imports_s=IMPORTED - START, inputs_s=t_prog - t_in,
                     program_s=time.perf_counter() - t_prog)
        log(json.dumps(dict(workload=cell.name, seed=seed, setup=setup,
                            **run.info)))
        out = _measure(run, cell, clock, seconds, trace, log)
        record = run.record()
    finally:
        run.close()
    del run
    gc.collect()
    if clock.cuda:
        torch.cuda.empty_cache()
    data.src, data.dst = data.src.to(device), data.dst.to(device)
    try:
        readings = spec.judge(mix["path"]).readings(record, data, cell)
    except Exception:   # a check that cannot be made fails the run
        traceback.print_exc()
        readings = {}
    readings.update(out["window"])
    ok, rows = judge_limits(readings, cell.limits)
    result = dict(correct=bool(ok and out["steps"] > 0
                               and out["failed"] == 0),
                  attempted=out["steps"], failed=out["failed"],
                  metrics=out["metrics"],
                  device=dict(
                      platform="gpu" if clock.cuda else device.type,
                      kind=(torch.cuda.get_device_name() if clock.cuda
                            else device.type),
                      count=cell.chips if clock.cuda else 0,
                      memory_peak_bytes=out["peak"], **out["device"]))
    if out["breakdown"] is not None:
        result["breakdown"] = out["breakdown"]
    result["checks"] = {name: dict(value=value, limit=limit)
                        for name, value, limit in rows}
    return result


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the port on an NVIDIA "
              "GPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda"))
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}; the benchmark "
              f"runs without JAX, flax and the JAX package", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
