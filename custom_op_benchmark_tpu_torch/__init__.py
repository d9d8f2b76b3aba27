"""custom_op_benchmark_tpu_torch — the PyTorch and CUDA port of
custom_op_benchmark_tpu, for NVIDIA Hopper (H100).

The JAX package beside it is the reference; this package imports neither
it nor JAX. Plain tensor code is PyTorch; every TPU kernel of the JAX
package on the ported path is a CUDA kernel written by hand for sm_90a
(``csrc/``), built at first use and bound with ctypes
(``ops/kernels/_build.py``).
"""

from custom_op_benchmark_tpu_torch.graph import (
    Graph,
    TiledGraph,
    from_coo,
    tile_graph,
)

__version__ = "0.1.0"

__all__ = ["Graph", "TiledGraph", "from_coo", "tile_graph"]
