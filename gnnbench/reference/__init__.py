"""The plain reference: PyTorch tensor code that imports nothing of the port.

``common.py`` holds the precision, the loss, AdamW and the comparison of
leaves; ``<family>.py`` a model family's forward pass and its operation and
byte counts; ``graph.py`` the checks of the port's graph views and sampled
blocks against the generated edges.
"""
