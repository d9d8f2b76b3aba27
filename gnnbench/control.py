"""The readings that a cell's limits are set from.

    python3 -m gnnbench.control --workload <name> --seeds 1,2,...
        [--control-seeds 1,2,3] [--kinds tf32,half_batch,f32] [--out FILE]

For each seed, in one process: the cell's set-up and checked steps (no
window), then the compared numbers of the program against the reference
(the lower readings, with each step's and each leaf's gaps) and, for the
control seeds, the same numbers with the reference put in the program's
place as each of ``--kinds``: ``tf32``, the control (the reference one
precision step below the configuration's float32); ``half_batch``, the
planted fault of a loss over half the batch; ``f32``, plain float32, a
witness of f32's own round-off. One JSON line a seed; the last line gives,
for each number, the largest program reading and, for each kind, the
smallest. Runs on the card, or with ``--device cpu`` at a size the caller
sets.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from gnnbench import gen, spec


def readings(cell, seed: int, device, kinds=()) -> dict:
    """One seed's program readings and those of each of ``kinds``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, mix = cell.config, cell.mix
    data = gen.make(cfg, mix, seed, device)
    data.src, data.dst = data.src.cpu(), data.dst.cpu()
    run = spec.path(mix["path"]).Run(cell, data, spec.family(cfg["family"]),
                                     seed, device)
    record = run.record()
    run.close()
    del run
    gc.collect()
    data.src, data.dst = data.src.to(device), data.dst.to(device)
    judge = spec.judge(mix["path"])
    details = {}
    out = dict(seed=seed, program=judge.readings(record, data, cell,
                                                 details=details),
               details=details)
    if kinds:
        for kind, (r, d) in judge.control(record, data, cell,
                                          kinds).items():
            out[kind], out[kind + "_details"] = r, d
    del record, data
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def summarise(rows: list, kinds=("tf32",)) -> dict:
    """The largest program reading of each number and, for each kind, the
    smallest."""
    out = {"lower": {}}
    for r in rows:
        for k, v in r["program"].items():
            out["lower"][k] = max(out["lower"].get(k, v), v)
        for kind in kinds:
            low = out.setdefault(kind, {})
            for k, v in r.get(kind, {}).items():
                low[k] = min(low.get(k, v), v)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--kinds", default="tf32")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    kinds = tuple(k for k in args.kinds.split(",") if k)
    rows = []
    for seed in seeds:
        rows.append(readings(cell, seed, torch.device(args.device),
                             kinds if seed in ctl else ()))
        print(json.dumps(rows[-1]), flush=True)
    summary = dict(workload=args.workload, **summarise(rows, kinds))
    if args.out:
        with open(args.out, "w") as f:
            for r in rows + [summary]:
                f.write(json.dumps(r) + "\n")
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
