"""Row width against time: a gather-sum at f32, bf16 and fp8 rows, and a
dense matmul in bf16 against fp8.

Counterpart of scripts/exp_dtype_width.py; a yardstick experiment, so it
times library calls, not the port's kernels.

1. A fused gather and sum over S = 3M random rows of a (131072, 128) table
   (``x[idx].float().sum(0)``, summed in f32) with 512-, 256- and 128-byte
   rows (f32, bf16, ``torch.float8_e4m3fn``). Where torch cannot gather
   float8 rows, they are gathered viewed as ``uint8`` (the record says
   which). Rows a second and bytes a second show whether narrow rows are
   bound by rows or by bytes.
2. A 4096³ matmul in bf16 (``@``) against fp8 e4m3 (``torch._scaled_mm``,
   unit scales, bf16 out), in TFLOP/s.

Runs on the CUDA device, ``--small`` at S = 300,000 and 1024³, or with
``--device cpu`` at a (1024, 128) table, S = 10,000 and 64³, timing
nothing.

Run:  python -m custom_op_benchmark_tpu_torch.experiments.exp_dtype_width [--small | --device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from custom_op_benchmark_tpu_torch.experiments import common

SIZES = {"full": (131072, 3_000_000, 4096), "small": (131072, 300_000, 1024),
         "cpu": (1024, 10_000, 64)}
WIDTH = 128
FP8 = torch.float8_e4m3fn


def fp8_gather(x: torch.Tensor, idx: torch.Tensor):
    """(how, gather): ``x[idx]`` where torch gathers float8 rows on this
    device, else the rows gathered viewed as uint8."""
    try:
        x[idx[:1]]
    except RuntimeError as err:
        print(f"float8 rows do not gather directly ({err}); gathering them "
              "viewed as uint8", flush=True)
        return "uint8 view", lambda x, idx: x.view(torch.uint8)[idx].view(
            FP8)
    return "direct", lambda x, idx: x[idx]


def run(device: torch.device, size: str = "full") -> dict:
    n, s, m = SIZES[size]
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, n, size=s)).to(device)
    x32 = torch.from_numpy(rng.standard_normal(
        (n, WIDTH), dtype=np.float32)).to(device)
    how, take8 = fp8_gather(x32.to(FP8), idx)
    rows = common.Rows(device)
    gather = {}
    for name, x, take in (
            ("f32 (512 B rows)", x32, lambda x, i: x[i]),
            ("bf16 (256 B rows)", x32.to(torch.bfloat16), lambda x, i: x[i]),
            ("fp8_e4m3 (128 B rows)", x32.to(FP8), take8)):
        ms = rows(f"gather {name}",
                  lambda x, i, take=take: take(x, i).float().sum(0), x, idx)
        row_bytes = WIDTH * x.element_size()
        gather[name] = dict(ms=ms, row_bytes=row_bytes, rows_per_s=(
            None if ms is None else s / ms * 1e3), bytes_per_s=(
            None if ms is None else s * row_bytes / ms * 1e3))
    del x32
    a32 = torch.from_numpy(rng.standard_normal(
        (m, m), dtype=np.float32)).to(device)
    one = torch.ones((), device=device)
    a16, a8 = a32.to(torch.bfloat16), a32.to(FP8)
    matmul = {}
    for name, fn, args in (
            ("bf16", lambda a, b: a @ b, (a16, a16)),
            ("fp8_e4m3", lambda a, b: torch._scaled_mm(
                a, b.t(), scale_a=one, scale_b=one,
                out_dtype=torch.bfloat16), (a8, a8))):
        ms = rows(f"matmul {m}^3 {name}", fn, *args)
        matmul[name] = dict(ms=ms, tflops=(None if ms is None
                                           else 2 * m ** 3 / ms / 1e9))
    return dict(device=common.where(device), table=[n, WIDTH], gathers=s,
                fp8_gather=how, gather=gather, matmul_m=m, matmul=matmul)


def main(argv=None) -> int:
    return common.run_main("exp_dtype_width", __doc__, run, argv)


if __name__ == "__main__":
    sys.exit(main())
