"""Optimizers written out over parameter trees, as the reference writes them
(not ``torch.optim``), so that both compute the same update. The reference's
jitted step updates its donated carry in place, and so does this one:

    opt = adam(warmup_cosine(1e-3, 100, 10_000), weight_decay=3e-6)
    opt_state = opt.init(params)
    scale, gnorm = clip_scale(grads, max_norm)
    opt.update_(params, grads, opt_state, scale, ok)

``apply_updates`` and ``clip_by_global_norm`` are the reference's functional
forms, which return new trees; the ``Trainer`` takes the in-place path
above.

``update_`` updates every parameter leaf, the optimizer's state and its step
in place, and leaves them all bit-unchanged where the 0-d bool ``ok`` is
false. No second tree is made. Adam runs leaf by leaf through
``kernels/adam`` (one fused pass on the card, its plain version in torch
calls on the CPU); SGD is plain tensor operations. A learning rate is a
float or a schedule ``fn(step) -> lr``, which both take on the device from
their int32 step, as the reference's jitted step does.

Paper recipe (§5.1.5): Adam, lr=1e-3, weight decay in {0, 3e-6} depending on
the dataset.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.kernels.adam.ops import adam_step_
from repro_torch.train.tree import leaves, tree_map


class GradientTransformation(NamedTuple):
    init: Callable
    update_: Callable  # (params, grads, state, scale, ok) -> None, in place


def _lr_at(lr, step: torch.Tensor):
    """The learning rate of the update whose step is ``step`` (the
    optimizer's step after it, int32 on the device): a float as it is, a
    schedule's value as a 0-d float32 tensor on the device."""
    return lr(step) if callable(lr) else lr


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0,
         moment_dtype=None) -> GradientTransformation:
    """Adam/AdamW. ``lr`` is a float or a schedule ``fn(step) -> lr``,
    evaluated at Adam's step after the update, as the reference does.

    Decoupled weight decay (AdamW-style), skipped for 1-D leaves (biases,
    norm scales). ``moment_dtype`` (e.g. ``torch.bfloat16``) stores mu/nu in
    a reduced type; the update math stays float32. Without it a bfloat16
    leaf keeps float32 moments, the reference's type for them after its
    first update. The step is an int32
    tensor on the parameters' device and the bias corrections ``1 − b^step``
    are computed from it in float32, as the reference computes them; so is
    a schedule's value, which the pass reads from device memory.
    """
    hyper = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)

    def _stored(x):
        if not x.is_floating_point():
            return x
        if moment_dtype is not None:
            return x.to(moment_dtype)
        # a bfloat16 leaf's moments are float32 from the reference's first
        # update on (its float32 sums are stored as they are); zeros are
        # the same in either type
        return x.to(torch.float32) if x.dtype == torch.bfloat16 else x

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
        lr_t = _lr_at(lr, state["step"] + 1)
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state["mu"]), leaves(state["nu"])):
            adam_step_(p, g, m, v, scale, ok, bc1, bc2, lr=lr_t, **hyper)
        state["step"].add_(ok.to(torch.int32))

    return GradientTransformation(init, update_)


def sgd(lr, momentum: float = 0.0) -> GradientTransformation:
    """SGD, with heavy-ball momentum ``mom = momentum·mom + g`` where
    ``momentum`` is not 0: ``p += -lr_t·(mom or g)`` for the clipped
    gradient ``g·scale``, in place, in plain tensor operations; a step whose
    ``ok`` is false leaves every bit."""
    def init(params):
        device = leaves(params)[0].device
        state = {"step": torch.zeros((), dtype=torch.int32, device=device)}
        if momentum:
            state["mom"] = tree_map(torch.zeros_like, params)
        return state

    def update_(params, grads, state, scale, ok):
        lr_t = _lr_at(lr, state["step"] + 1)
        moms = leaves(state["mom"]) if momentum else [None] * len(leaves(params))
        for p, g, m in zip(leaves(params), leaves(grads), moms):
            g = g * scale
            if m is not None:
                g = momentum * m + g
                m.copy_(torch.where(ok, g, m))
            p.copy_(torch.where(ok, (p + -lr_t * g).to(p.dtype), p))
        state["step"].add_(ok.to(torch.int32))

    return GradientTransformation(init, update_)


def chain_weight_decay(grads, params, wd: float):
    """L2 (coupled) weight decay added to the gradients, matrices only:
    a new tree ``g + wd·p`` (``g`` where ``p`` is 1-D)."""
    return tree_map(lambda g, p: g + wd * p if p.ndim > 1 else g, grads, params)


def warmup_cosine(base_lr: float, warmup: int, total: int, floor: float = 0.0):
    """The reference's schedule: linear warm-up to ``base_lr`` over
    ``warmup`` steps, then a half cosine down to ``floor`` at ``total``.
    ``fn(step)`` takes an int tensor (or a number) and returns a 0-d float32
    tensor on its device, each operation the reference's in float32, the
    cosine rounded once from float64 (the correctly rounded value)."""
    def fn(step):
        if not torch.is_tensor(step):
            step = torch.tensor(step)
        step = step.to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        c = torch.cos((math.pi * t).double()).float()
        cos = floor + (base_lr - floor) * 0.5 * (1 + c)
        return torch.where(step < warmup, warm, cos)
    return fn


def clip_scale(grads, max_norm: float):
    """The global-norm clip's factor ``min(1, max_norm / (norm + 1e-12))``
    (always applied, as the reference does) and the global norm, as 0-d
    float32 tensors on the gradients' device."""
    sq = [torch.sum(torch.square(g.float())) for g in leaves(grads)]
    gnorm = torch.sqrt(torch.sum(torch.stack(sq)))
    return torch.clamp(max_norm / (gnorm + 1e-12), max=1.0), gnorm


def clip_by_global_norm(grads, max_norm: float):
    """The reference's functional clip: ``(grads · scale, gnorm)`` with
    ``clip_scale``'s factor and norm, as new tensors. A leaf comes out in
    its dtype promoted with float32, as the reference's ``g * scale``
    promotes it: a bfloat16 gradient comes out float32."""
    scale, gnorm = clip_scale(grads, max_norm)
    return tree_map(
        lambda g: g.to(torch.promote_types(g.dtype, scale.dtype)) * scale,
        grads), gnorm


def apply_updates(params, updates):
    """A new tree ``p + u``, each leaf in ``p``'s dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)

