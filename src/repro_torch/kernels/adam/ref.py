"""Plain PyTorch version of one Adam step of one leaf: the arithmetic of the
reference's ``adam`` (``train/optimizer.py`` runs it leaf by leaf),
one torch call per operation: the in-place step that CPU tensors take
and the CUDA pass of ``csrc/adam.cu`` is held against.

Every operation is a single rounding in float32 (and a bfloat16 leaf's
store one more), so the CUDA pass, which
writes each one with ``__fmul_rn``/``__fadd_rn``/``__fdiv_rn``/
``__fsqrt_rn`` in this order, gives these bits on the card.
"""
from __future__ import annotations

import torch


def decay_factor(lr: float, weight_decay: float, dtype) -> float:
    """The decay's factor for a constant ``lr``, as the value the pass
    multiplies by: f32(lr·wd) for a float32 leaf (a Python float product,
    rounded once); for a bfloat16 leaf bf16(lr·wd), rounded once from the
    double, as jnp takes a Python scalar into a bfloat16 product."""
    # the decay factor lr·wd rounded once from float64, on the host
    x = torch.tensor(lr * weight_decay, dtype=torch.float64)  # staticcheck: ignore[RL404]
    return float(x.to(torch.bfloat16 if dtype == torch.bfloat16
                      else torch.float32))


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
    Python floats rounded once). The temporaries are this leaf's alone.

    A bfloat16 leaf (its gradient bfloat16, its moments float32) takes the
    reference's promotions: the clipped gradient ``float32(g) * scale``,
    the moments and ``u`` in float32, the decay term the bfloat16 product
    ``bf16(lr·wd) * p`` with a float ``lr`` and ``f32(lr_t·wd) * p`` in
    float32 with a schedule's, and ``p`` rounded once from
    ``float32(p) + u``."""
    g = g.float() * scale
    mu = (b1 * m.float() + (1 - b1) * g).to(m.dtype)
    nu = (b2 * v.float() + (1 - b2) * torch.square(g)).to(v.dtype)
    u = -lr * (mu.float() / bc1) / (torch.sqrt(nu.float() / bc2) + eps)
    if weight_decay and p.ndim > 1:
        if p.dtype == torch.float32:
            u = u - lr * weight_decay * p
        elif torch.is_tensor(lr):
            u = u - (lr * weight_decay) * p.float()
        else:
            u = u - p * torch.tensor(decay_factor(lr, weight_decay, p.dtype),
                                     dtype=p.dtype, device=p.device)
    new_p = (p + u).to(p.dtype)
    del u
    p.copy_(torch.where(ok, new_p, p))
    m.copy_(torch.where(ok, mu, m))
    v.copy_(torch.where(ok, nu, v))
