"""The device the port runs on."""

from __future__ import annotations

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
