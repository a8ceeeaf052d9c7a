"""LSQ+ uniform affine quantizer with the paper's closed-form STE gradients.

    v    = (theta - beta) / alpha
    code = clamp(round(v), N_b, P_b),  N_b = -2^(b-1), P_b = 2^(b-1) - 1
    Q    = alpha * code + beta

    dQ/dtheta = 1[N_b < v < P_b]                                   (Eq. 4)
    dQ/dalpha = N_b | round(v) - v | P_b  (v <= N_b | inside | v >= P_b)  (Eq. 5)
    dQ/dbeta  = 1[v <= N_b or v >= P_b]                            (Eq. 6)

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


# symmetric int8 helpers (KV caches, expert weights), in the reference's op
# order: its int8 KV-cache attention and MoE expert products read them so

INT8_MAX = 127


def dequantize_symmetric(q: torch.Tensor, scale: torch.Tensor,
                         dtype=torch.float32) -> torch.Tensor:
    """Symmetric (zero-offset) dequant: ``q * scale`` in ``dtype``, both
    factors cast *before* the multiply, as the reference casts them."""
    return q.to(dtype) * scale.to(dtype)


def quantize_symmetric(vals: torch.Tensor, scale: torch.Tensor,
                       dtype=torch.int8) -> torch.Tensor:
    """Symmetric quant onto the int8 grid: ``round(vals / scale)`` (half to
    even) clipped to ±127. The division stays a division: jitted XLA keeps
    it one where the divisor is a tensor."""
    return torch.clamp(torch.round(vals / scale), -INT8_MAX,
                       INT8_MAX).to(dtype)


def requantize_int8(codes: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
    """Re-project stored int8 codes onto a coarser grid: ``round(codes *
    ratio)`` clipped to ±127, ``ratio = old_scale / new_scale`` ≤ 1."""
    return torch.clamp(torch.round(codes.to(torch.float32) * ratio),
                       -INT8_MAX, INT8_MAX).to(torch.int8)


def init_alpha(std: float, b: int) -> float:
    """LSQ-style step-size init: alpha ≈ 2·E|θ| / sqrt(P_b) with θ~N(0,std)."""
    if b < 1:
        return 1.0  # unused placeholder for the b=0 slot
    _, p_b = int_bounds(b)
    mean_abs = std * 0.7978845608  # E|N(0,std)| = std * sqrt(2/pi)
    return float(2.0 * mean_abs / max(p_b, 1) ** 0.5)


def _reduce_to_shape(g: torch.Tensor, shape) -> torch.Tensor:
    """Sum-reduce cotangent ``g`` down to its broadcast source ``shape``."""
    shape = tuple(shape)
    if tuple(g.shape) == shape:
        return g
    extra = g.ndim - len(shape)
    if extra:
        g = g.sum(dim=tuple(range(extra)))
    keep = tuple(i for i, s in enumerate(shape) if s == 1 and g.shape[i] != 1)
    if keep:
        g = g.sum(dim=keep, keepdim=True)
    return g.reshape(shape)


class _LSQQuantize(torch.autograd.Function):
    """Fake quantization at ``b`` bits with the STE backward of Eqs. 4–6."""

    @staticmethod
    def forward(ctx, theta, alpha, beta, b):
        n_b, p_b = int_bounds(b)
        v = (theta - beta) / alpha
        vbar = torch.clamp(torch.round(v), n_b, p_b)
        ctx.b = b
        ctx.shapes = (alpha.shape, beta.shape)
        ctx.save_for_backward(v, vbar)
        return dequantize_codes(vbar, alpha, beta)

    @staticmethod
    def backward(ctx, g):
        n_b, p_b = int_bounds(ctx.b)
        v, vbar = ctx.saved_tensors
        alpha_shape, beta_shape = ctx.shapes
        inside = (v > n_b) & (v < p_b)
        d_theta = torch.where(inside, g, 0.0)                         # Eq. 4
        dq_dalpha = torch.where(v <= n_b, float(n_b),
                                torch.where(v >= p_b, float(p_b), vbar - v))
        d_alpha = _reduce_to_shape(g * dq_dalpha, alpha_shape)        # Eq. 5
        d_beta = _reduce_to_shape(g * torch.where(inside, 0.0, 1.0),     # Eq. 6
                                  beta_shape)
        return d_theta, d_alpha, d_beta, None


def lsq_quantize(theta: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                 b: int) -> torch.Tensor:
    """Fake-quantize ``theta`` at ``b`` bits. alpha: scalar tensor, beta: (d,)
    or scalar tensor. Differentiable in all three through the STE."""
    return _LSQQuantize.apply(theta, alpha, beta, int(b))


def mixed_expectation(rows: torch.Tensor, probs: torch.Tensor,
                      alpha: torch.Tensor, beta: torch.Tensor,
                      bits: tuple) -> torch.Tensor:
    """Paper Eq. (9), ē = Σ_i p_i · Q(e, α_i, β, b_i), as the plain composition
    of ``lsq_quantize``: rows (..., d), probs (..., m), alpha (m,), beta (d,).
    The fused kernel is ``repro_torch.kernels.mpe_qat``; this is its oracle."""
    out = torch.zeros_like(rows)
    for i, b in enumerate(bits):
        if b == 0:
            continue  # zero vector contribution (feature-selection case)
        q = lsq_quantize(rows, alpha[i], beta, int(b))
        out = torch.addcmul(out, probs[..., i:i + 1], q)
    return out
