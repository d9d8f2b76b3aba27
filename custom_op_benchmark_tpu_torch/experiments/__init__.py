"""Experiments on the CUDA card (``python -m`` entry points)."""
