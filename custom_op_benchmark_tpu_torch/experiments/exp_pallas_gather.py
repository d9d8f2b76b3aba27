"""ELL copy-sum: the hand-written row gather S3 against its plain version.

Counterpart of scripts/exp_pallas_gather.py, at its own shape: x (131,072,
128) f32 and one ELL bucket of cols (125,000, 16) int32 (2M slots) from
``np.random.default_rng(0)``. The probe op is ``y[r] = Σ_k x[cols[r, k]]``,
a pure gather and reduce; S3 runs it as a one-bucket table
(``graph.ell.one_bucket_table``), the form the ELL copy-SpMM generalises to
every bucket of a packing in one launch. It checks S3 against the plain
version on the first 64 rows (rtol/atol 1e-5), then on the first 512 rows
of the full call, then times

    xla_gather_sum   the plain version, x[cols].sum(1)
    gather_sum       S3 (csrc/gather_sum.cu) over the one-bucket table

by CUDA events, each in ms and in GB/s of gathered rows (R·D·d·4 bytes),
and prints one JSON line ``{"exp_pallas_gather": {...}}``. Needs a CUDA
device.

Run:  python -m custom_op_benchmark_tpu_torch.experiments.exp_pallas_gather
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from custom_op_benchmark_tpu_torch.graph.ell import one_bucket_table
from custom_op_benchmark_tpu_torch.ops.kernels.gather_sum import (
    gather_sum,
    gather_sum_plain,
)
from custom_op_benchmark_tpu_torch.utils import cuda_device
from custom_op_benchmark_tpu_torch.utils.benchlib import bench_ms

N, D = 131_072, 128
R, K = 2_000_000 // 16, 16
RTOL = ATOL = 1e-5


def inputs(device):
    """x (N, D) normal and cols (R, K) uniform in [0, N), in the order the
    reference draws them."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32))
    cols = torch.from_numpy(rng.integers(0, N, size=(R, K)).astype(np.int32))
    return cols.to(device), x.to(device)


def run(cols, x, *, warmup=1, iters=10, repeats=3) -> dict:
    ok = bool(torch.allclose(gather_sum(cols[:64], x),
                             gather_sum_plain(cols[:64], x),
                             rtol=RTOL, atol=ATOL))
    print(f"correctness ok: {ok}", flush=True)
    ok_full = bool(torch.allclose(gather_sum(cols, x)[:512],
                                  gather_sum_plain(cols[:512], x),
                                  rtol=RTOL, atol=ATOL))
    print(f"full correctness ok: {ok_full}", flush=True)
    out = {"allclose": ok, "allclose_full": ok_full}
    gbytes = cols.numel() * x.shape[1] * 4 / 1e9
    table = one_bucket_table(cols)
    for name, fn in (("xla_gather_sum", gather_sum_plain),
                     ("gather_sum", gather_sum)):
        bench_ms(out, name, fn, table, x, warmup=warmup, iters=iters,
                 repeats=repeats, edges=cols.numel())
        out[f"{name}_gb_s"] = gbytes / (out[name] / 1e3)
        print(f"  {name:40s} {out[f'{name}_gb_s']:9.1f} GB/s", flush=True)
    out["device"] = torch.cuda.get_device_name(x.device)
    return out


def main() -> int:
    cols, x = inputs(cuda_device())
    out = run(cols, x)
    print(json.dumps({"exp_pallas_gather": out}))
    return 0 if out["allclose"] and out["allclose_full"] else 1


if __name__ == "__main__":
    sys.exit(main())
