"""Dense layer. The kernel keeps the reference's (d_in, d_out) layout."""
from __future__ import annotations

import torch

from repro_torch.nn import init as initializers


class Dense:
    @staticmethod
    def init(gen: torch.Generator, d_in: int, d_out: int):
        return {"kernel": initializers.glorot_uniform(gen, (d_in, d_out)),
                "bias": torch.zeros((d_out,), device=gen.device)}

    @staticmethod
    def apply(params, x):
        return x @ params["kernel"] + params["bias"]
