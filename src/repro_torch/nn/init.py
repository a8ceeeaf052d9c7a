"""Parameter initializers drawing from an explicit ``torch.Generator``.

The paper initializes embeddings from N(0, 3e-3) (§5.1.5); dense layers use
glorot-uniform. Each tensor is made in float32 on the generator's device.
"""
from __future__ import annotations

import math

import torch

EMBED_STD = 3e-3  # paper §5.1.5


def normal(gen: torch.Generator, shape, std=EMBED_STD):
    return std * torch.randn(shape, generator=gen, device=gen.device)


def he_normal(gen: torch.Generator, shape):
    """N(0, 2 / fan_in) for a (fan_in, fan_out) kernel."""
    fan_in = shape[0]
    return torch.randn(shape, generator=gen, device=gen.device) * math.sqrt(
        2.0 / fan_in)


def glorot_uniform(gen: torch.Generator, shape):
    """U(-l, l) with l = sqrt(6 / (fan_in + fan_out)) for a (fan_in, fan_out)
    kernel."""
    fan_in, fan_out = shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape, device=gen.device).uniform_(-limit, limit,
                                                          generator=gen)
