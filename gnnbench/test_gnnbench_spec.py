"""The harness finds its pieces by name and refuses unknown ones; the
result line has the contract's keys; nothing imports JAX."""

import ast
import json
from pathlib import Path

import pytest
import torch

from gnnbench import run, spec
from gnnbench.conftest import tiny_cell

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "custom_op_benchmark_tpu", "bench"}
PORT = "custom_op_benchmark_tpu_torch"


def test_every_cell_resolves():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert cell.config["family"] and cell.mix["path"]
        spec.family(cell.config["family"])
        spec.reference(cell.config["family"])
        spec.path(cell.mix["path"])
        spec.judge(cell.mix["path"])
        assert cell.limits["workload"] == w["name"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)


def test_config_files_match_benchmark():
    bench = spec.benchmark()
    for c in bench["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and "assumed" in cfg


@pytest.mark.parametrize("kind, name", [
    ("configs", "no_such_config"), ("mixes", "no_such_mix"),
    ("metrics", "no_such_metric"), ("families", "no_such_family"),
    ("paths", "no_such_path"), ("workload", "no_such.cell"),
    ("configs", "../configs/arxiv_gat"), ("metrics", "a b")])
def test_unknown_names_refused(kind, name):
    find = {"configs": spec.config, "mixes": spec.mix,
            "metrics": spec.metric_reader, "families": spec.family,
            "paths": spec.path, "workload": spec.cell}[kind]
    with pytest.raises(KeyError):
        find(name)


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_jax_flax_or_jax_package_imported():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_reference_and_judges_import_nothing_of_the_port():
    for sub in ("reference", "judges"):
        for path in (HERE / sub).glob("*.py"):
            assert PORT not in _imports(path), path
    for name in ("counts.py", "timing.py", "gen.py", "spec.py"):
        assert PORT not in _imports(HERE / name)


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {"custom_op_benchmark_tpu_torch.ops": 1, "jaxtyping": 1,
            "flaxen": 1, "numpy": 1}
    assert run.forbidden_modules(mods) == []
    mods.update({"custom_op_benchmark_tpu.ops.ell": 1, "jax.numpy": 1})
    assert run.forbidden_modules(mods) == ["custom_op_benchmark_tpu", "jax"]


def test_main_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = run.main(["--workload", "arxiv_gat.ogbn_arxiv", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == "" and "CUDA" in out.err


def test_result_line_keys():
    cell = tiny_cell("arxiv_gat.ogbn_arxiv")
    lines = []
    res = run.run_cell(cell, 2 ** 31 + 5, 0.2, False, "cpu", log=lines.append)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert list(res["checks"]) == list(cell.limits["numbers"])
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    assert json.loads(json.dumps(res)) == res
    assert json.loads(lines[0])["view"] == "ell"
    # Off the card no metric is read.
    assert res["metrics"] == {}
