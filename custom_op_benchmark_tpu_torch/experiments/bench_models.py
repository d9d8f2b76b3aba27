"""Model-level strategy benchmarks on the reference clique workload.

Counterpart of scripts/bench_models.py: on 512 disjoint 30-cliques (n =
15,360, e = 460,800), the forward time and the train-step time (forward,
backward, one AdamW update) of

    transformer/block whole_stack=False   GraphTransformer(dim 512, 8
                                          heads, 3 layers, out 10) on the
                                          dense blocks, scattering and
                                          gathering at every attention
    transformer/block whole_stack=True    the same, the whole stack in the
                                          (B, L, D) layout
    transformer/tiled (K4)                the same on the 128×128 tiles:
                                          K4 forward, K1–K3 backward
    gat/segment, gat/ell, gat/block       GAT(hidden 64, out 10, 3 layers,
                                          8 heads) on 128-d features, the
                                          same weights on each path

timed by CUDA events (``benchlib.bench_fn``, median of repeats). The GAT's
block and ELL outputs are held to its segment output at 2e-3 (the
strategies' gate): the script prints their max errors and exits 1 when
either is above it. Prints one JSON line ``{"bench_models": {...}}``.

Runs on the CUDA device, or with ``--device cpu`` on 4×30 cliques at the
same widths, where it runs every path (one forward and one train step
each) and the gate, and times nothing.

Run:  python -m custom_op_benchmark_tpu_torch.experiments.bench_models [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import sys

import numpy as np
import torch

from custom_op_benchmark_tpu_torch.graph import (
    block_graph,
    clique_batch,
    tile_graph,
)
from custom_op_benchmark_tpu_torch.models import GAT, GraphTransformer
from custom_op_benchmark_tpu_torch.ops import ell_dual
from custom_op_benchmark_tpu_torch.train import (
    create_train_state,
    make_train_step,
)
from custom_op_benchmark_tpu_torch.utils.benchlib import bench_fn
from custom_op_benchmark_tpu_torch.utils.device import cuda_device

CLIQUES = (512, 30)
SMALL_CLIQUES = (4, 30)
TRANSFORMER = dict(dim=512, num_heads=8, num_layers=3, out_dim=10)
GAT_CFG = dict(hidden_dim=64, out_dim=10, num_layers=3, num_heads=8)
GAT_FEAT = 128
GATE = 2e-3     # the strategies' allclose gate (utils/bench_suite.RTOL)
TIMING = dict(warmup=1, iters=5, repeats=3)


def bench_model(name, model, g, x, labels, mask, views, timed):
    """The model's forward output (eval mode, no gradients) and its row:
    forward and train-step ms on the card, or one train step run and not
    timed elsewhere. The weights are restored after the steps."""
    init = copy.deepcopy(model.state_dict())
    model.eval()

    @torch.no_grad()
    def fwd(x):
        return model(g, x, **views)

    out = fwd(x)
    state = create_train_state(model)
    train_step = make_train_step(apply_kwargs=views)

    def step(x):
        return train_step(state, g, x, labels, mask)

    row = {"fwd_ms": None, "step_ms": None}
    if timed:
        row["fwd_ms"] = bench_fn(fwd, (x,), name=f"fwd_{name}",
                                 **TIMING).time_s * 1e3
        row["step_ms"] = bench_fn(step, (x,), name=f"step_{name}",
                                  **TIMING).time_s * 1e3
        print(f"{name:40s} fwd {row['fwd_ms']:9.3f} ms   train step "
              f"{row['step_ms']:9.3f} ms", flush=True)
    else:
        loss, _ = step(x)
        if not torch.isfinite(loss):
            raise AssertionError(f"{name}: the train step's loss is {loss}")
        print(f"{name:40s} not measured (no CUDA device)", flush=True)
    model.load_state_dict(init)
    return out, row


def run(device=None, cliques=CLIQUES, seed: int = 0) -> dict:
    """Every row on ``device`` (default: the CUDA device); times them only
    there. Returns the rows and the GAT's errors against its segment
    path."""
    device = cuda_device() if device is None else torch.device(device)
    timed = device.type == "cuda"
    g_host = clique_batch(*cliques)
    g = g_host.to(device)
    n = g.n_nodes
    bg = block_graph(g)
    tg = tile_graph(g_host, 128, 128, device=device)
    ell = ell_dual(g)
    rng = np.random.default_rng(seed)
    labels = torch.from_numpy(rng.integers(0, 10, size=n)).to(device)
    mask = torch.ones(n, dtype=torch.bool, device=device)

    def features(width):
        return torch.from_numpy(rng.standard_normal(
            (n, width), dtype=np.float32)).to(device)

    rows = {}
    x512 = features(TRANSFORMER["dim"])
    for whole in (False, True):
        model = GraphTransformer(
            **TRANSFORMER, block_whole_stack=whole,
            generator=torch.Generator().manual_seed(seed)).to(device)
        name = f"transformer/block whole_stack={whole}"
        _, rows[name] = bench_model(name, model, g, x512, labels, mask,
                                    {"block": bg}, timed)
    _, rows["transformer/tiled (K4)"] = bench_model(
        "transformer/tiled (K4)", model, g, x512, labels, mask,
        {"tiled": tg}, timed)
    del model, x512

    x128 = features(GAT_FEAT)
    gat = GAT(**GAT_CFG, in_dim=GAT_FEAT,
              generator=torch.Generator().manual_seed(seed)).to(device)
    outs = {}
    for name, views in (("gat/segment", {}), ("gat/ell", {"ell": ell}),
                        ("gat/block", {"block": bg})):
        outs[name], rows[name] = bench_model(name, gat, g, x128, labels,
                                             mask, views, timed)
    errs = {f"gat_{p}_vs_segment_max_err": float(
        (outs[f"gat/{p}"] - outs["gat/segment"]).abs().max())
        for p in ("block", "ell")}
    for key, err in errs.items():
        print(f"{key}: {err:.3e} (gate {GATE:g})", flush=True)
    where = torch.cuda.get_device_name(device) if timed else str(device)
    return {"device": where, "n": n, "e": g.n_edges, "rows": rows, **errs,
            "gate": GATE, "ok": all(err <= GATE for err in errs.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to run (default: the CUDA device, and fail "
                    "without one); cpu runs 4x30 cliques and times nothing")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        result = run(torch.device("cpu"), SMALL_CLIQUES)
    else:
        try:
            device = cuda_device()
        except RuntimeError as err:
            print(f"bench_models: {err} (pass --device cpu for the small "
                  "size)", file=sys.stderr)
            return 1
        result = run(device)
    print(json.dumps({"bench_models": result}), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
