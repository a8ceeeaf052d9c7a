"""LSQ+ uniform affine quantizer: integer codes and their dequantization.

    v    = (theta - beta) / alpha
    code = clamp(round(v), N_b, P_b),  N_b = -2^(b-1), P_b = 2^(b-1) - 1
    Q    = alpha * code + beta

``alpha`` is one step size per bit-width, ``beta`` one offset per embedding
dimension (§3.3). b == 0 is the dropped-feature case, handled by callers.

The dequant is a fused multiply-add (``torch.addcmul``): the reference's
jitted serve path contracts ``alpha * code + beta`` into one FMA, and the
CUDA lookup kernel uses ``__fmaf_rn``, so all three round once and agree
bit for bit. A separate multiply and add would differ by 1 ulp in about a
fifth of the values.
"""
from __future__ import annotations

import torch


def int_bounds(b: int) -> tuple[int, int]:
    """Signed-integer bounds [N_b, P_b] for a b-bit code."""
    if b < 1:
        raise ValueError(f"bit-width must be >= 1, got {b}")
    return -(2 ** (b - 1)), 2 ** (b - 1) - 1


def quantize_codes(theta: torch.Tensor, alpha, beta, b: int) -> torch.Tensor:
    """Integer codes (no dequant) — used when exporting packed tables.
    ``torch.round`` rounds half to even, as the reference does."""
    n_b, p_b = int_bounds(b)
    v = (theta - beta) / alpha
    return torch.clamp(torch.round(v), n_b, p_b).to(torch.int32)


def dequantize_codes(codes: torch.Tensor, alpha, beta) -> torch.Tensor:
    """``alpha * codes + beta`` in float32, rounded once (FMA)."""
    return torch.addcmul(beta, codes.to(torch.float32), alpha)


def init_alpha(std: float, b: int) -> float:
    """LSQ-style step-size init: alpha ≈ 2·E|θ| / sqrt(P_b) with θ~N(0,std)."""
    if b < 1:
        return 1.0  # unused placeholder for the b=0 slot
    _, p_b = int_bounds(b)
    mean_abs = std * 0.7978845608  # E|N(0,std)| = std * sqrt(2/pi)
    return float(2.0 * mean_abs / max(p_b, 1) ** 0.5)
