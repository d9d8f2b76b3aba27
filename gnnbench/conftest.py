"""pytest settings of the benchmark's own tests: ``python -m pytest gnnbench``.

Tests that need a CUDA device carry the ``chip`` marker and take the
``cuda`` fixture, which skips them where there is none; everything else
runs on the CPU at tiny sizes with the port's plain kernel versions.
"""

from __future__ import annotations

import pytest
import torch

from gnnbench import spec

# Tiny graphs at the published widths: the CPU tests' cut of each mix.
TINY = {
    "full_graph": dict(nodes=300, undirected_edges=1500, train_nodes=150),
    "sampled": dict(nodes=2000, undirected_edges=30000, train_nodes=1000),
}
TINY_BATCH = 64
# Cells whose files are here but which BENCHMARK.json does not list yet:
# {workload: (config, traffic)}. The sampled cell is correct on the card,
# but its host-bound rate spreads past what a bound can hold (PERF.md §7).
UNLISTED = {"reddit_sage.fanout_25_10": ("reddit_sage", "fanout_25_10")}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device; skipped where there is none")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def tiny_cell(workload: str) -> spec.Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` (or of ``UNLISTED``) with
    its graph cut to the CPU tests' size (widths, fanouts and limits as
    committed)."""
    cell = (spec.assemble(workload, *UNLISTED[workload])
            if workload in UNLISTED else spec.cell(workload))
    cell.mix["graph"].update(TINY[cell.mix["path"]])
    if "batch_size" in cell.mix:
        cell.mix["batch_size"] = TINY_BATCH
    cell.mix["trace_steps"] = 2
    return cell
