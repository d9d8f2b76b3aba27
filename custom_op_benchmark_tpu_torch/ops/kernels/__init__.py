"""Hand-written CUDA kernels (csrc/), each beside its plain PyTorch version."""
