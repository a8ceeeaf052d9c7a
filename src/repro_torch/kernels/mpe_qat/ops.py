"""Public wrapper of the fused Eq. 9 mixture: one ``torch.autograd.Function``
whose forward and backward are the CUDA kernels of ``csrc/mpe_qat.cu`` for
tensors on the card, and the plain versions of ``ref.py`` for tensors on the
CPU.

On CUDA tensors it launches the kernels or raises; there is no fallback.
``mixed_expectation_fwd.launches`` and ``mixed_expectation_bwd.launches``
count kernel launches, and only those (one backward launch is the main
kernel and its small reduction of the per-block partials). The kernels
pick their vector width from d and the tensors' alignment themselves.

Under an op walk each call is one region (``repro_torch.kernels.region``)
charged its analytic cost; on meta tensors it returns empties of the
kernel's output shapes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import region as _region
from repro_torch.kernels.build import load_library
from repro_torch.kernels.mpe_qat.ref import (mixed_expectation_bwd_ref,
                                             mixed_expectation_fwd_ref)

MAX_WIDTHS = 16   # kMaxWidths in csrc/mpe_qat.cu
MAX_BITS = 24     # kMaxBits
MAX_D = 16384     # kMaxWideD: rows wider than 256 take a block each


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("mpe_qat")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mpe_qat_fwd.argtypes = [p, p, p, p, p, i, ll, i, p, p]
    lib.mpe_qat_fwd.restype = i
    lib.mpe_qat_bwd.argtypes = [p, p, p, p, p, p, i, ll, i, p, p, p, p, p]
    lib.mpe_qat_bwd.restype = i
    lib.mpe_qat_bwd_partial_rows.argtypes = [ll, i]
    lib.mpe_qat_bwd_partial_rows.restype = ll
    return lib


def _check_inputs(rows, probs, alpha, beta, bits, g=None):
    """Raise on what the kernels do not take: float32, contiguous, one
    device, rows (T, d), probs (T, m), alpha (m,), beta (d,)."""
    if rows.ndim != 2:
        raise ValueError(f"rows must be (T, d), got {tuple(rows.shape)}")
    t, d = rows.shape
    m = len(bits)
    if not 1 <= m <= MAX_WIDTHS:
        raise ValueError(f"{m} candidate widths; the kernels take 1..{MAX_WIDTHS}")
    if any(not 0 <= int(b) <= MAX_BITS for b in bits):
        raise ValueError(f"widths {bits} outside the kernels' 0..{MAX_BITS}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"d={d} outside the kernels' 1..{MAX_D}")
    named = {"rows": (rows, (t, d)), "probs": (probs, (t, m)),
             "alpha": (alpha, (m,)), "beta": (beta, (d,))}
    if g is not None:
        named["g"] = (g, (t, d))
    for what, (x, shape) in named.items():
        if x.device != rows.device:
            raise ValueError(f"{what} lies on {x.device}, rows on {rows.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{what}: expected torch.float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{what}: expected shape {shape}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{what} must be contiguous")


def _bits_array(bits):
    return (ctypes.c_int * len(bits))(*(int(b) for b in bits))


def mixed_expectation_fwd(rows, probs, alpha, beta, bits) -> torch.Tensor:
    """Eq. 9 forward: (T, d) on the card through the kernel, on the CPU
    through the plain version."""
    if _region.WALK is not None or rows.is_meta:
        return _region.run("mixed_expectation_fwd", mixed_expectation_fwd,
                           (rows, probs, alpha, beta, bits),
                           meta=rows.is_meta, shape=_fwd_shape, cost=fwd_cost)
    if rows.device.type == "cpu":
        return mixed_expectation_fwd_ref(rows, probs, alpha, beta, bits)
    if rows.device.type != "cuda":
        raise ValueError(f"mixed_expectation runs on CUDA or the CPU, not on "
                         f"{rows.device}")
    _check_inputs(rows, probs, alpha, beta, bits)
    t, d = rows.shape
    out = torch.empty_like(rows)
    if t == 0:
        return out
    c_bits = _bits_array(bits)
    dev = rows.device
    with torch.cuda.device(dev):
        err = _library().mpe_qat_fwd(
            rows.data_ptr(), probs.data_ptr(), alpha.data_ptr(),
            beta.data_ptr(), ctypes.addressof(c_bits), len(bits), t, d,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mpe_qat forward launch failed: CUDA error {err}")
    mixed_expectation_fwd.launches += 1
    return out


def mixed_expectation_bwd(rows, probs, alpha, beta, g, bits):
    """Eq. 9 backward: (drows, dprobs, dalpha, dbeta) on the card through the
    kernels (deterministic: no float atomics), on the CPU through the plain
    version."""
    if _region.WALK is not None or rows.is_meta:
        return _region.run("mixed_expectation_bwd", mixed_expectation_bwd,
                           (rows, probs, alpha, beta, g, bits),
                           meta=rows.is_meta, shape=_bwd_shape, cost=bwd_cost)
    if rows.device.type == "cpu":
        return mixed_expectation_bwd_ref(rows, probs, alpha, beta, g, bits)
    if rows.device.type != "cuda":
        raise ValueError(f"mixed_expectation runs on CUDA or the CPU, not on "
                         f"{rows.device}")
    _check_inputs(rows, probs, alpha, beta, bits, g)
    t, d = rows.shape
    m = len(bits)
    drows, dprobs = torch.empty_like(rows), torch.empty_like(probs)
    if t == 0:
        return drows, dprobs, torch.zeros_like(alpha), torch.zeros_like(beta)
    lib = _library()
    sums = torch.empty((m + d,), dtype=torch.float32, device=rows.device)
    c_bits = _bits_array(bits)
    dev = rows.device
    with torch.cuda.device(dev):
        # float64 scratch for the per-block partials of dα and dβ
        partials = torch.empty((lib.mpe_qat_bwd_partial_rows(t, d), m + d),
                               dtype=torch.float64, device=dev)  # staticcheck: ignore[RL404]
        err = lib.mpe_qat_bwd(
            rows.data_ptr(), probs.data_ptr(), alpha.data_ptr(),
            beta.data_ptr(), g.data_ptr(), ctypes.addressof(c_bits), m, t, d,
            drows.data_ptr(), dprobs.data_ptr(), partials.data_ptr(),
            sums.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mpe_qat backward launch failed: CUDA error {err}")
    mixed_expectation_bwd.launches += 1
    return drows, dprobs, sums[:m], sums[m:]


mixed_expectation_fwd.launches = 0
mixed_expectation_bwd.launches = 0


def _fwd_shape(rows, probs, alpha, beta, bits):
    return torch.empty_like(rows)


def _bwd_shape(rows, probs, alpha, beta, g, bits):
    return (torch.empty_like(rows), torch.empty_like(probs),
            torch.empty_like(alpha), torch.empty_like(beta))


def fwd_cost(rows, probs, alpha, beta, bits) -> dict:
    """Eq. 9 forward from shapes: each element quantized at every width
    (scale, round, clamp, rescale: ~6 operations) and weighted into the
    sum (2); rows and probs read, the output written."""
    t, d, m = rows.shape[0], rows.shape[-1], len(bits)
    return {"flops": 8 * t * d * m,
            "bytes": _region.nbytes(rows, probs, alpha, beta, rows)}


def bwd_cost(rows, probs, alpha, beta, g, bits) -> dict:
    """Eq. 9 backward from shapes: ~12 operations an element and width;
    rows, probs and g read, their gradients written."""
    t, d, m = rows.shape[0], rows.shape[-1], len(bits)
    return {"flops": 12 * t * d * m,
            "bytes": _region.nbytes(rows, probs, alpha, beta, g, rows, probs,
                                    alpha, beta)}


class _MixedExpectation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, probs, alpha, beta, bits):
        ctx.bits = bits
        ctx.save_for_backward(rows, probs, alpha, beta)
        return mixed_expectation_fwd(rows, probs, alpha, beta, bits)

    @staticmethod
    def backward(ctx, g):
        rows, probs, alpha, beta = ctx.saved_tensors
        drows, dprobs, dalpha, dbeta = mixed_expectation_bwd(
            rows, probs, alpha, beta, g.contiguous(), ctx.bits)
        return drows, dprobs, dalpha, dbeta, None


def mixed_expectation_kernel(rows, probs, alpha, beta, bits) -> torch.Tensor:
    """Eq. 9 over rows (..., d) and probs (..., m), differentiable in all
    four tensors; ``bits`` is the static tuple of candidate widths."""
    bits = tuple(int(b) for b in bits)
    lead = rows.shape[:-1]
    out = _MixedExpectation.apply(rows.reshape(-1, rows.shape[-1]).contiguous(),
                                  probs.reshape(-1, probs.shape[-1]).contiguous(),
                                  alpha.contiguous(), beta.contiguous(), bits)
    return out.reshape(*lead, rows.shape[-1])


def mixed_expectation_kernel_sharded(rows, probs, alpha, beta, bits, *,
                                     mesh=None) -> torch.Tensor:
    """Eq. 9 on a mesh: rows split over every axis, α/β replicated;
    bit-exact forward. ``mixed_expectation_kernel`` when no mesh of more
    than one rank is active (see ``repro_torch.dist.shard``)."""
    from repro_torch.dist.shard import sharded_mixed_expectation
    return sharded_mixed_expectation(rows, probs, alpha, beta, bits,
                                     mesh=mesh)
