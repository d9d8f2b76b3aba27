"""Flax's dtype rules for the port's dense layers and layer norms.

The JAX package's models take a compute ``dtype`` (mixed precision: f32
parameters, bf16 activations, f32 logits) and leave the rest to flax:

- ``nn.Dense(dtype=dt)`` casts its input, kernel and bias to ``dt`` and
  computes in it; with no ``dtype`` it computes in the promoted type of its
  input and kernel, so a bf16 input to f32 weights computes in f32;
- ``nn.LayerNorm(dtype=dt)`` takes its statistics, scale and bias in f32
  (at least) and casts the result to ``dt``; with no ``dtype`` the result
  is the promoted type of the input and the parameters.

:func:`dense` and :func:`layer_norm` apply the same rules to a
``torch.nn.Linear`` and a ``torch.nn.LayerNorm``. ``torch.autocast`` does
not: it keeps a layer norm's output in f32. In float32 both are exactly
the module's own call.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``layer(x)`` in ``dtype``, or in the promoted type of x and the
    weight when ``dtype`` is None (one rounding, at the output)."""
    dt = dtype or torch.promote_types(x.dtype, layer.weight.dtype)
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), bias)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``ln(x)`` computed in f32 and rounded once to ``dtype`` (or to the
    promoted type of x and the parameters when ``dtype`` is None)."""
    out = dtype or torch.promote_types(x.dtype, ln.weight.dtype)
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(out)
