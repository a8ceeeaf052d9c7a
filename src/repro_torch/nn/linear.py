"""Dense layer. The kernel keeps the reference's (d_in, d_out) layout; a
layer made with ``use_bias=False`` has no ``"bias"`` entry."""
from __future__ import annotations

import torch

from repro_torch.nn import init as initializers


class Dense:
    @staticmethod
    def init(gen: torch.Generator, d_in: int, d_out: int, *,
             use_bias: bool = True,
             kernel_init=initializers.glorot_uniform):
        params = {"kernel": kernel_init(gen, (d_in, d_out))}
        if use_bias:
            params["bias"] = torch.zeros((d_out,), device=gen.device)
        return params

    @staticmethod
    def apply(params, x):
        y = x @ params["kernel"]
        return y + params["bias"] if "bias" in params else y
