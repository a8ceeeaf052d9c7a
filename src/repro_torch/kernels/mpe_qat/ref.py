"""Plain PyTorch version of the fused Eq. 9 mixture and its backward: the
oracle the CUDA kernels are held against, and the path CPU tensors take.

``mixed_expectation_ref`` is ``core.quantizer.mixed_expectation``, the
composition with its gradients through autograd (the reference's oracle of
that name); the forward here is the same without autograd. The
backward is written out from the reference's TPU kernel body
(``_bwd_kernel``), width by width. The products that the CUDA kernels round
once are ``torch.addcmul`` in both (one fused multiply-add): the dequant
``α_i·code + β`` and the accumulations ``acc + p_i·q`` and
``drows + p_i·g_inside``. The division ``(e − β) / α_i`` is IEEE and the
rounding half-to-even, as in the kernels, so ``out`` and ``drows`` come out
bit-identical to the kernels'. The reductions (``dprobs``, ``dα``, ``dβ``)
sum the same float32 products as the kernels, in another order: in float32,
as the reference does, on the CPU path; in float64, rounded once, as the
kernels do, where they are held against it (``sum_dtype``). Float32 sums of
a ``dα`` over thousands of rows taken in two orders part by more than the
contract (rtol 1e-4, atol 1e-6) when the total cancels to near 0; float64
ones agree to the last bit or nearly.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantizer import int_bounds, mixed_expectation


def _quantize(rows, alpha_i, beta, b):
    """v, its clipped code and the dequantized value at width ``b``."""
    n_b, p_b = int_bounds(b)
    v = (rows - beta) / alpha_i
    codes = torch.clamp(torch.round(v), n_b, p_b)
    return v, codes, torch.addcmul(beta, codes, alpha_i)


def mixed_expectation_ref(rows, probs, alpha, beta, *, bits) -> torch.Tensor:
    """The reference's oracle: Eq. 9 as the plain composition of the LSQ+
    quantizer, its STE gradients through autograd."""
    return mixed_expectation(rows, probs, alpha, beta, bits)


def mixed_expectation_fwd_ref(rows, probs, alpha, beta, bits) -> torch.Tensor:
    """rows (T, d), probs (T, m), alpha (m,), beta (d,) -> (T, d)."""
    with torch.no_grad():
        return mixed_expectation(rows, probs, alpha, beta, bits)


def mixed_expectation_bwd_ref(rows, probs, alpha, beta, g, bits, *,
                              sum_dtype=torch.float32):
    """The four cotangents of Eq. 9 for output cotangent ``g`` (T, d):
    drows (T, d) (Eq. 4), dprobs (T, m) = <g, Q_i> per row, dalpha (m,)
    (Eq. 5) and dbeta (d,) (Eq. 6), the last three summed in ``sum_dtype``
    (float64 as the CUDA kernel sums). Widths of 0 bits get zero columns."""
    drows = torch.zeros_like(rows)
    dprobs = torch.zeros_like(probs)
    dalpha = torch.zeros_like(alpha)
    dbeta = torch.zeros_like(beta, dtype=sum_dtype)
    for i, b in enumerate(bits):
        if b == 0:
            continue
        n_b, p_b = int_bounds(int(b))
        p_i = probs[:, i:i + 1]
        v, codes, q = _quantize(rows, alpha[i], beta, int(b))
        inside = (v > n_b) & (v < p_b)
        dprobs[:, i] = (g * q).to(sum_dtype).sum(dim=1).to(probs.dtype)
        drows = torch.addcmul(drows, p_i, torch.where(inside, g, 0.0))
        dq_da = torch.where(v <= n_b, float(n_b),
                            torch.where(v >= p_b, float(p_b), codes - v))
        dalpha[i] = (p_i * g * dq_da).to(sum_dtype).sum().to(alpha.dtype)
        dbeta = dbeta + (p_i * torch.where(inside, 0.0, g)).to(
            sum_dtype).sum(dim=0)
    return drows, dprobs, dalpha, dbeta.to(beta.dtype)
