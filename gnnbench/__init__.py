"""The benchmark of the port ``custom_op_benchmark_tpu_torch`` (PyTorch, CUDA).

One command runs one cell of ``BENCHMARK.json`` once, from the root of a
checkout, on a machine with an NVIDIA GPU::

    python3 -m gnnbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

It makes the graph, features, labels, split and weights on the device from
``--seed``, builds the port's path for the cell (its own host builds count
as set-up), drives the path's first steps for the correctness check, times
the path for ``--seconds``, checks what the path produced against the plain
reference, and prints one JSON line last.

Everything is found by name from ``BENCHMARK.json`` (``spec.py``):

- ``configs/<config>.json``: a model configuration, its source and cuts;
  its ``family`` names ``families/<family>.py`` (the port's model) and
  ``reference/<family>.py`` (the plain model, which imports nothing of the
  port);
- ``mixes/<traffic>.json``: the graph and the traffic, read by the one
  generator ``gen.py``; its ``path`` names ``paths/<path>.py`` (the port's
  pieces the window drives);
- ``judges/<path>.py``: the check of a path against the plain reference,
  which imports nothing of the port;
- ``limits/<workload>.json``: each compared number's limit and the readings
  it was set from (``python3 -m gnnbench.control`` reads them);
- ``metrics/<metric>.py``: the reader of one metric.

The yardstick is frozen here, apart from the port: ``timing.py`` (CUDA
event timing and the profiler arithmetic), ``counts.py`` (operation and
byte counts, the table of peaks), ``gen.py`` and ``reference/``. Nothing
under this folder imports JAX, flax or the JAX package.

The sampled cell ``reddit_sage.fanout_25_10`` (``configs/reddit_sage.json``,
``mixes/fanout_25_10.json``, ``paths/sampled.py``, ``judges/sampled.py``,
its limits and its readers ``sample_ms``, ``batch_wait_ms`` and
``sampled_copy_spmm_roofline``) is here whole and tested, but not listed in
``BENCHMARK.json``: its host-bound rate spreads wider than a bound can hold.

Tests: ``python -m pytest gnnbench -q`` (CPU, tiny sizes; tests marked
``chip`` skip without a card).
"""
