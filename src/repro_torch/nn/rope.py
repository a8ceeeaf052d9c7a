"""Rotary position embeddings (RoPE) [arXiv:2104.09864], as the reference
forms them: frequencies ``1/theta^(2i/hd)`` and angles ``position·freq`` in
float32, the rotation in float32, cast back to ``x``'s dtype. Computed on
the fly (no cached tables), so a decode step can apply any position.

The frequencies are the jitted reference's bit for bit; its float32
``sin``/``cos`` and the rotation's products round within an ulp or so of
torch's, so the two packages agree within 1e-6 on unit-scale inputs.
"""
from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """``1 / theta^e`` with ``e = 2i / hd`` in float32. Jitted XLA turns
    ``1 / pow(theta, e)`` into ``pow(theta, -e)``, correctly rounded: so
    does this, in float64 rounded once."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    # XLA's correctly rounded pow: float64, rounded once
    return torch.pow(float(theta), -exponent.to(torch.float64)).to(  # staticcheck: ignore[RL404,PF101]
        torch.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to
    (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)          # (hd/2,)
    angles = positions[..., :, None, None].to(torch.float32) * freqs
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)
