"""flax's default initialisation, for the port's models.

Every model starts its parameters as the flax module it mirrors does:
``Dense`` kernels LeCun-normal (a normal truncated to ±2 standard
deviations, variance 1/fan_in) and zero biases, ``LayerNorm`` scales one
and biases zero, GAT's attention vectors ``a_l``/``a_r`` Glorot-uniform,
GCN's bias ``b`` and GIN's ``eps`` zero. Draws come from ``generator``, so
a seed gives the same weights each time (not JAX's: its PRNG differs;
tests load JAX's weights through ``convert.flax_to_state_dict`` instead).
"""

from __future__ import annotations

import math

import torch
from torch import nn


def lecun_normal_(weight: torch.Tensor, generator=None) -> torch.Tensor:
    """flax's default Dense init: truncated normal, variance 1/fan_in."""
    fan_in = weight.shape[1]
    # Std of a standard normal truncated to [-2, 2].
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def glorot_uniform_(t: torch.Tensor, generator=None) -> torch.Tensor:
    """flax's glorot_uniform for a 2-D (fan_in, fan_out) parameter."""
    limit = math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
    return nn.init.uniform_(t, -limit, limit, generator=generator)


@torch.no_grad()
def flax_init_(model: nn.Module, generator=None) -> None:
    """Re-initialise every parameter of ``model`` as flax would."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        for name in ("a_l", "a_r"):
            if isinstance(getattr(m, name, None), nn.Parameter):
                glorot_uniform_(getattr(m, name), generator)
        for name in ("b", "eps"):
            if isinstance(getattr(m, name, None), nn.Parameter):
                getattr(m, name).zero_()
