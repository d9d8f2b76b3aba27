"""The port's pieces that a traffic path composes, as its own fit function
composes them, set up for the window: ``full_graph`` (``fit_full_graph``'s
view choice, train state and step) and ``sampled`` (``fit_sampled``'s
sampler, batches, prefetch and step).

A path's ``Run(cell, data, family, seed, device)`` builds the program from
the generated data (its host builds are set-up), drives the checked steps
and the warm-up, and then offers ``step()`` for the window, ``counts()`` and
``probe()`` for the per-layer metrics, ``record()`` for the check and
``close()``. Each has a port-free judge in ``judges/<path>.py``.
"""
