"""Convert a flax parameter tree (GraphTransformer, GAT, GCN, GIN,
GraphSAGE) into the port's ``state_dict``.

The tree is the JAX package's ``params`` as nested dicts of numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``). Name and layout changes:

- flax ``Dense`` kernels are ``(in, out)``; ``nn.Linear`` weights are
  ``(out, in)``, so kernels transpose (``W``, ``W_res``, ``W_self``,
  ``W_neigh``, ...). ``bias`` keeps its name.
- flax ``LayerNorm`` ``scale`` becomes ``weight``.
- the flax submodule ``layer{i}`` becomes ``layers.{i}``.
- plain parameters keep name and layout: GAT's attention vectors ``a_l``
  and ``a_r`` (h, d), GCN's bias ``b``, GIN's scalar ``eps`` (with its
  ``mlp1``/``mlp2`` Dense layers converting as above).

Both frameworks must also agree on two defaults the port sets explicitly
(models/transformer.py): flax's LayerNorm uses eps 1e-6 (torch: 1e-5) and
flax's ``gelu`` is the tanh approximation (torch: exact).

The compute ``dtype`` of GAT and GraphTransformer changes nothing here:
parameters stay float32 under it (flax's ``param_dtype``, the port's
``precision.dense``/``layer_norm`` cast them where they are used), so the
same tree loads into an f32 or a bf16 model.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_LAYER = re.compile(r"^layer(\d+)$")


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: str) -> None:
        for name, value in tree.items():
            m = _LAYER.match(name)
            key = f"layers.{m.group(1)}" if m else name
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.")
                continue
            arr = np.asarray(value)
            if key == "kernel":
                key, arr = "weight", arr.T
            elif key == "scale":
                key = "weight"
            out[prefix + key] = torch.tensor(arr)

    walk(params, "")
    return out
