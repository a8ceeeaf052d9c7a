"""LayerNorm, BatchNorm and RMSNorm over the last axis, written out by hand.

LayerNorm is the reference's: mean, biased variance,
``(x − mean) / sqrt(var + 1e-5)·scale + bias`` (not ``F.layer_norm``, whose
reciprocal square root rounds differently). BatchNorm (paper §5.1.5):
running statistics live in a separate ``state`` dict, returned alongside the
output. ``torch.nn.BatchNorm1d`` is not used: the reference keeps its own
state layout and update rule — the *biased* batch variance (``correction=0``)
and ``0.9·old + 0.1·batch`` — which this module follows op for op.
"""
from __future__ import annotations

import torch

EPS = 1e-5


class LayerNorm:
    @staticmethod
    def init(dim: int, device=None):
        return {"scale": torch.ones((dim,), device=device),
                "bias": torch.zeros((dim,), device=device)}

    @staticmethod
    def apply(params, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, correction=0)
        y = (x - mean) / torch.sqrt(var + EPS)
        return y * params["scale"] + params["bias"]


class BatchNorm:
    MOMENTUM = 0.9

    @staticmethod
    def init(dim: int, device=None):
        return {"scale": torch.ones((dim,), device=device),
                "bias": torch.zeros((dim,), device=device)}

    @staticmethod
    def init_state(dim: int, device=None):
        return {"mean": torch.zeros((dim,), device=device),
                "var": torch.ones((dim,), device=device)}

    @staticmethod
    def apply(params, state, x, *, train: bool = False):
        """Returns (y, new_state). Train mode normalizes with the batch
        statistics and moves the running ones; eval mode reads them."""
        if train:
            axes = tuple(range(x.ndim - 1))
            mean = x.mean(dim=axes)
            var = x.var(dim=axes, correction=0)
            mom = BatchNorm.MOMENTUM
            new_state = {"mean": mom * state["mean"] + (1 - mom) * mean.detach(),
                         "var": mom * state["var"] + (1 - mom) * var.detach()}
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        y = (x - mean) / torch.sqrt(var + EPS) * params["scale"] + params["bias"]
        return y, new_state


class RMSNorm:
    """``x·(1/sqrt(mean(x²) + 1e-6))·scale`` with the statistics in float32,
    cast back to ``x``'s dtype (the LLaMA/Qwen convention). Jitted XLA
    sums the squares in its own order and takes ``1/sqrt`` as its
    reciprocal square root, so the two packages agree within a float32
    ulp or two, not bit for bit."""

    EPS = 1e-6

    @staticmethod
    def init(dim: int, dtype=torch.float32, device=None):
        return {"scale": torch.ones((dim,), dtype=dtype, device=device)}

    @staticmethod
    def apply(params, x):
        x32 = x.to(torch.float32)
        ms = torch.mean(torch.square(x32), dim=-1, keepdim=True)
        y = x32 * (1.0 / torch.sqrt(ms + RMSNorm.EPS))
        return (y * params["scale"]).to(x.dtype)
