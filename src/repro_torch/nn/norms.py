"""BatchNorm over the last axis, written out by hand (paper §5.1.5).

Eval mode normalizes with the running statistics held in a separate
``state`` dict. ``torch.nn.BatchNorm1d`` is not used: the reference keeps
its own state layout and update rule (biased batch variance, momentum 0.9
on the old value), which the training slice ports with the train mode.
"""
from __future__ import annotations

import torch

EPS = 1e-5


class BatchNorm:
    @staticmethod
    def init(dim: int, device=None):
        return {"scale": torch.ones((dim,), device=device),
                "bias": torch.zeros((dim,), device=device)}

    @staticmethod
    def init_state(dim: int, device=None):
        return {"mean": torch.zeros((dim,), device=device),
                "var": torch.ones((dim,), device=device)}

    @staticmethod
    def apply(params, state, x):
        """Eval mode: normalize with the running mean and variance."""
        return ((x - state["mean"]) / torch.sqrt(state["var"] + EPS)
                * params["scale"] + params["bias"])
