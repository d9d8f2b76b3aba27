"""Experiments and measurement drivers on the CUDA card (``python -m``
entry points; ``common`` is the drivers' shared command line), and the
host-only plan probes."""
