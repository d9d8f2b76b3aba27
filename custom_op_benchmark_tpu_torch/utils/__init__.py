"""Utilities."""

from custom_op_benchmark_tpu_torch.utils.device import cuda_device, exact_f32

__all__ = ["cuda_device", "exact_f32"]
