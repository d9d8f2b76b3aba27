"""Utilities."""

from custom_op_benchmark_tpu_torch.utils.device import cuda_device

__all__ = ["cuda_device"]
