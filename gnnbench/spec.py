"""Find a cell's pieces by name from ``BENCHMARK.json``.

A workload names a configuration and a traffic mix; the configuration file
names its model family, the mix its path. Each is a file of its own under
this folder, so a later cell, model or metric is added by adding files and
entries, never by editing one that is here.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _check_name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise KeyError(f"bad {kind} name {name!r}")
    return name


def _json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{_check_name(kind, name)}.json"
    if not path.is_file():
        raise KeyError(f"unknown {kind[:-1]} {name!r}: no {path.name} "
                       f"under gnnbench/{kind}/")
    return json.loads(path.read_text())


def _module(kind: str, name: str):
    ident = _check_name(kind, name).replace("-", "_").replace(".", "_")
    if not (HERE / kind / f"{ident}.py").is_file():
        raise KeyError(f"unknown {kind[:-1]} {name!r}: no {ident}.py under "
                       f"gnnbench/{kind}/")
    return importlib.import_module(f"gnnbench.{kind}.{ident}")


def config(name: str) -> dict:
    return _json("configs", name)


def mix(name: str) -> dict:
    return _json("mixes", name)


def limits(workload: str) -> dict:
    return _json("limits", workload)


def family(name: str):
    """The port's side of a model family (``families/<name>.py``)."""
    return _module("families", name)


def reference(name: str):
    """The plain reference of a model family (``reference/<name>.py``)."""
    return _module("reference", name)


def path(name: str):
    """The port's pieces a traffic path drives (``paths/<name>.py``)."""
    return _module("paths", name)


def judge(name: str):
    """The port-free check of a path (``judges/<name>.py``)."""
    return _module("judges", name)


def metric_reader(name: str):
    """The reader of one metric (``metrics/<name>.py``)."""
    return _module("metrics", name)


def benchmark() -> dict:
    return json.loads(BENCHMARK.read_text())


@dataclasses.dataclass
class Cell:
    """One workload with everything it names, loaded."""

    name: str
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list
    chips: int


def assemble(workload: str, config_name: str, traffic: str,
             chips: int = 1, bench: dict = None) -> Cell:
    """A cell from its files, with the metrics of ``bench`` (none without
    it) that apply to it."""
    bench = bench or {"end_to_end": [], "per_layer": []}

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return Cell(name=workload, config=config(config_name), mix=mix(traffic),
                limits=limits(workload),
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)],
                chips=int(chips))


def cell(workload: str) -> Cell:
    """The workload ``workload`` of ``BENCHMARK.json``; raises KeyError for
    an unknown name."""
    bench = benchmark()
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"unknown workload {workload!r}; BENCHMARK.json has "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    return assemble(workload, w["config"], w["traffic"], w["chips"], bench)
