"""Public wrapper of the cold fill: the CUDA kernel of
``csrc/tiered_cold.cu`` for tensors on the card, the plain version
(``ref.py``) for tensors on the CPU.

On CUDA tensors it launches the kernel or raises; there is no fallback.
``cold_fill.launches`` counts kernel launches, and only those. The kernel
reads the entry counts from the staged buffer on the device, so one launch
(or one CUDA-graph replay of it) serves any number of cold ids up to the
buffer's capacity; a buffer whose counts do not fit it (negative, more
entries than the capacity, more words than the buffer) writes nothing.

Under an op walk each call is one region (``repro_torch.kernels.region``)
charged its analytic cost; on meta tensors it returns ``out`` unwritten.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.packing import words_per_row
from repro_torch.device import on_card, raw_stream
from repro_torch.kernels import region as _region
from repro_torch.kernels.build import load_library
from repro_torch.kernels.tiered_cold.ref import cold_fill_ref

MAX_BUCKETS = 16  # kMaxBuckets in csrc/tiered_cold.cu
MAX_BITS = 31


class _ColdPlan(ctypes.Structure):
    """Mirror of ``struct ColdPlan`` in ``csrc/tiered_cold.cu``."""
    _fields_ = [("alpha", ctypes.c_void_p),
                ("beta", ctypes.c_void_p),
                ("bits", ctypes.c_int * MAX_BUCKETS),
                ("wpr", ctypes.c_int * MAX_BUCKETS),
                ("n_buckets", ctypes.c_int),
                ("d", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = load_library("tiered_cold")
    if lib.tiered_cold_plan_bytes() != ctypes.sizeof(_ColdPlan):
        raise RuntimeError("csrc/tiered_cold.cu's ColdPlan and _ColdPlan "
                           "differ in size")
    fn = lib.tiered_cold
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [p, p, ll, ll, p, ll, p]
    fn.restype = ctypes.c_int
    return fn


def capacity(buf: torch.Tensor, n_out: int, n_buckets: int) -> int:
    """The most entries a staged buffer of ``buf``'s length can hold for an
    output of ``n_out`` rows: each entry takes a row index and at least one
    word, and writes a row of its own."""
    return max(min(n_out, (buf.numel() - n_buckets) // 2), 0)


def _check(out, buf, alpha, beta, bits, d):
    if not 1 <= len(bits) <= MAX_BUCKETS:
        raise ValueError(f"{len(bits)} width buckets; the kernel takes 1.."
                         f"{MAX_BUCKETS}")
    if any(not 0 <= b <= MAX_BITS for b in bits):
        raise ValueError(f"code widths {bits} outside the kernel's 0.."
                         f"{MAX_BITS}")
    named = {"out": (out, torch.float32), "buf": (buf, torch.int32),
             "alpha": (alpha, torch.float32), "beta": (beta, torch.float32)}
    for what, (t, dtype) in named.items():
        if t.device != out.device:
            raise ValueError(f"{what} lies on {t.device}, out on {out.device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
    if out.shape[-1] != d or buf.ndim != 1:
        raise ValueError(f"expected out (..., {d}) and a 1-D buffer, got "
                         f"{tuple(out.shape)} and {tuple(buf.shape)}")
    if tuple(alpha.shape) != (len(bits),) or tuple(beta.shape) != (d,):
        raise ValueError(f"expected alpha ({len(bits)},) and beta ({d},), "
                         f"got {tuple(alpha.shape)} and {tuple(beta.shape)}")
    if buf.numel() < len(bits):
        raise ValueError(f"the staged buffer holds {buf.numel()} words, "
                         f"fewer than its {len(bits)} counts")


def cold_fill(out: torch.Tensor, buf: torch.Tensor, meta, alpha: torch.Tensor,
              beta: torch.Tensor) -> torch.Tensor:
    """In place: ``out`` (..., d) float32 takes the dequantized cold rows
    staged in ``buf`` at their (flat) row indices; other rows keep their
    values. Returns ``out``."""
    if _region.WALK is not None or out.is_meta:
        return _region.run("tiered_cold", cold_fill,
                           (out, buf, meta, alpha, beta), meta=out.is_meta,
                           shape=lambda out, *_: out, cost=cost)
    bits, d = tuple(int(b) for b in meta["bits"]), int(meta["d"])
    _check(out, buf, alpha, beta, bits, d)
    flat = out.view(-1, d)
    if out.device.type == "cpu":
        cold_fill_ref(flat, buf, bits, d, alpha, beta)
        return out
    if out.device.type != "cuda":
        raise ValueError(f"cold_fill runs on CUDA or the CPU, not on "
                         f"{out.device}")
    c = _ColdPlan()
    c.alpha, c.beta = alpha.data_ptr(), beta.data_ptr()
    for i, b in enumerate(bits):
        c.bits[i] = b
        c.wpr[i] = words_per_row(d, b) if b else 0
    c.n_buckets, c.d = len(bits), d
    n_out = flat.shape[0]
    dev = out.device
    with on_card(dev):
        err = _kernel()(ctypes.addressof(c), buf.data_ptr(), buf.numel(),
                        capacity(buf, n_out, len(bits)), flat.data_ptr(),
                        n_out, raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"tiered_cold kernel launch failed: CUDA error "
                           f"{err}")
    cold_fill.launches += 1
    return out


cold_fill.launches = 0


def cost(out, buf, meta, alpha, beta) -> dict:
    """The fill from shapes, at most: the whole staged buffer read, every
    row of ``out`` written with a multiply-add an element (the rows that
    are cold depend on the request)."""
    return {"flops": 2 * out.numel(),
            "bytes": _region.nbytes(buf, alpha, beta, out)}
