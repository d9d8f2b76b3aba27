"""The device the port runs on, and the matmul precision of its checks."""

from __future__ import annotations

import contextlib

import torch


def cuda_device() -> torch.device:
    """The CUDA device; raises when no CUDA device is present.

    There is no CPU fallback: code that measures or trains on the card
    asks for it here and stops where there is none.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels need an "
                           "NVIDIA GPU")
    return torch.device("cuda")


@contextlib.contextmanager
def exact_f32():
    """f32 matmuls and convolutions in full f32 on the card (TF32 off)
    inside the block, restored after it: the precision of the dense
    oracles that checks compare with (the reference's ``"highest"``)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
