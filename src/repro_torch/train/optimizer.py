"""Optimizers written out over parameter trees, as the reference writes them
(not ``torch.optim``), so that both compute the same update:

    opt = adam(1e-3, weight_decay=3e-6)
    opt_state = opt.init(params)
    updates, opt_state = opt.update(grads, opt_state, params)
    params = apply_updates(params, updates)

Paper recipe (§5.1.5): Adam, lr=1e-3, weight decay in {0, 3e-6} depending on
the dataset. Every function returns new tensors and updates none in place.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.train.tree import leaves, tree_map


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)


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
    def _stored(x):
        return x.to(moment_dtype) if (moment_dtype is not None
                                      and x.is_floating_point()) else x

    def init(params):
        device = leaves(params)[0].device
        return {"step": torch.zeros((), dtype=torch.int32, device=device),
                "mu": tree_map(lambda p: _stored(torch.zeros_like(p)), params),
                "nu": tree_map(lambda p: _stored(torch.zeros_like(p)), params)}

    def update(grads, state, params):
        step = state["step"] + 1
        mu = tree_map(lambda m, g: _stored(b1 * m.float() + (1 - b1) * g.float()),
                      state["mu"], grads)
        nu = tree_map(lambda v, g: _stored(b2 * v.float()
                                           + (1 - b2) * torch.square(g.float())),
                      state["nu"], grads)
        step_f = step.to(torch.float32)
        # torch.full, not torch.tensor: a fill kernel, where a copy from
        # the host would make the host wait for the whole backward pass
        bc1 = 1 - torch.pow(torch.full((), b1, device=step.device), step_f)
        bc2 = 1 - torch.pow(torch.full((), b2, device=step.device), step_f)

        def _upd(m, v, p):
            m32, v32 = m.float(), v.float()
            u = -lr * (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
            if weight_decay and p.ndim > 1:
                u = u - lr * weight_decay * p
            return u

        updates = tree_map(_upd, mu, nu, params)
        return updates, {"step": step, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by ``min(1, max_norm / (norm + 1e-12))`` (always,
    as the reference does). Returns (grads, global norm)."""
    sq = [torch.sum(torch.square(g.float())) for g in leaves(grads)]
    gnorm = torch.sqrt(torch.sum(torch.stack(sq)))
    scale = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), gnorm
