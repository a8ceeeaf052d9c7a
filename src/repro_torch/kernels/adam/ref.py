"""Plain PyTorch version of one Adam step of one leaf: the arithmetic of the
reference's ``adam`` (``train/optimizer.py`` runs it leaf by leaf),
one torch call per operation: the in-place step that CPU tensors take
and the CUDA pass of ``csrc/adam.cu`` is held against.

Every operation is a single rounding in float32, so the CUDA pass, which
writes each one with ``__fmul_rn``/``__fadd_rn``/``__fdiv_rn``/
``__fsqrt_rn`` in this order, gives these bits on the card.
"""
from __future__ import annotations

import torch


def adam_step_ref_(p, g, m, v, scale, ok, bc1, bc2, *, lr, b1, b2, eps,
                   weight_decay) -> None:
    """In place: p, m and v take one Adam step with the clipped gradient
    ``g * scale`` where the 0-d bool ``ok`` holds, and keep their bits where
    it does not. The moments are stored in their own type (``m.dtype``);
    ``bc1`` and ``bc2`` are the bias corrections ``1 − b^step``; the
    decoupled weight decay applies to leaves of more than one dimension
    only. ``lr`` is a float, or a schedule's value as a 0-d float32
    tensor: then the decay's factor ``lr * weight_decay`` is a float32
    product, as the reference forms it (with a float, a product of two
    Python floats rounded once). The temporaries are this leaf's alone."""
    g = (g * scale).float()
    mu = (b1 * m.float() + (1 - b1) * g).to(m.dtype)
    nu = (b2 * v.float() + (1 - b2) * torch.square(g)).to(v.dtype)
    u = -lr * (mu.float() / bc1) / (torch.sqrt(nu.float() / bc2) + eps)
    if weight_decay and p.ndim > 1:
        u = u - lr * weight_decay * p
    new_p = (p + u).to(p.dtype)
    del u
    p.copy_(torch.where(ok, new_p, p))
    m.copy_(torch.where(ok, mu, m))
    v.copy_(torch.where(ok, nu, v))
