"""Optimizers written out over parameter trees, as the reference writes them
(not ``torch.optim``), so that both compute the same update. The reference's
jitted step updates its donated carry in place, and so does this one:

    opt = adam(1e-3, weight_decay=3e-6)
    opt_state = opt.init(params)
    scale, gnorm = clip_scale(grads, max_norm)
    opt.update_(params, grads, opt_state, scale, ok)

``update_`` updates every parameter leaf, both moments and Adam's step in
place, leaf by leaf (``kernels/adam``: one fused pass on the card, its plain
version in torch calls on the CPU), and leaves them all bit-unchanged where
the 0-d bool ``ok`` is false. No second tree is made.

Paper recipe (§5.1.5): Adam, lr=1e-3, weight decay in {0, 3e-6} depending on
the dataset.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.kernels.adam.ops import adam_step_
from repro_torch.train.tree import leaves, tree_map


class GradientTransformation(NamedTuple):
    init: Callable
    update_: Callable  # (params, grads, state, scale, ok) -> None, in place


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0,
         moment_dtype=None) -> GradientTransformation:
    """Adam/AdamW at a constant ``lr`` (schedules come with the reference's
    ``warmup_cosine``).

    Decoupled weight decay (AdamW-style), skipped for 1-D leaves (biases,
    norm scales). ``moment_dtype`` (e.g. ``torch.bfloat16``) stores mu/nu in
    a reduced type; the update math stays float32. The step is an int32
    tensor on the parameters' device and the bias corrections ``1 − b^step``
    are computed from it in float32, as the reference computes them.
    """
    hyper = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)

    def _stored(x):
        return x.to(moment_dtype) if (moment_dtype is not None
                                      and x.is_floating_point()) else x

    def init(params):
        device = leaves(params)[0].device
        return {"step": torch.zeros((), dtype=torch.int32, device=device),
                "mu": tree_map(lambda p: _stored(torch.zeros_like(p)), params),
                "nu": tree_map(lambda p: _stored(torch.zeros_like(p)), params)}

    def update_(params, grads, state, scale, ok):
        step_f = (state["step"] + 1).to(torch.float32)
        # torch.full, not torch.tensor: a fill kernel, where a copy from
        # the host would make the host wait for the whole backward pass
        bc1 = 1 - torch.pow(torch.full((), b1, device=step_f.device), step_f)
        bc2 = 1 - torch.pow(torch.full((), b2, device=step_f.device), step_f)
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state["mu"]), leaves(state["nu"])):
            adam_step_(p, g, m, v, scale, ok, bc1, bc2, **hyper)
        state["step"].add_(ok.to(torch.int32))

    return GradientTransformation(init, update_)


def clip_scale(grads, max_norm: float):
    """The global-norm clip's factor ``min(1, max_norm / (norm + 1e-12))``
    (always applied, as the reference does) and the global norm, as 0-d
    float32 tensors on the gradients' device."""
    sq = [torch.sum(torch.square(g.float())) for g in leaves(grads)]
    gnorm = torch.sqrt(torch.sum(torch.stack(sq)))
    return torch.clamp(max_norm / (gnorm + 1e-12), max=1.0), gnorm

