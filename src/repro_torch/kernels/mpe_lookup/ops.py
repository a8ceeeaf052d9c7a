"""Public wrapper of the packed lookup: the CUDA kernel for tensors on the
card, the plain version (``ref.py``) for tensors on the CPU.

On a CUDA tensor the wrapper launches ``csrc/mpe_lookup.cu`` or raises; there
is no fallback. ``packed_lookup.launches`` counts kernel launches, and only
those.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.packing import words_per_row
from repro_torch.kernels.build import load_library
from repro_torch.kernels.mpe_lookup.ref import packed_lookup_ref

MAX_BUCKETS = 16  # kMaxBuckets in csrc/mpe_lookup.cu


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("mpe_lookup").mpe_lookup
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, ctypes.c_longlong, i, p, p, p, p, p, i, p, p, i, p, p]
    fn.restype = i
    return fn


def _check(t: torch.Tensor, what: str, dtype, shape, device):
    if not torch.is_tensor(t):
        raise TypeError(f"{what}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{what} lies on {t.device}, the ids on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _launch(table, meta, ids: torch.Tensor) -> torch.Tensor:
    bits, d = tuple(meta["bits"]), int(meta["d"])
    dev = ids.device
    n = int(table["width_idx"].shape[0])
    if not 1 <= len(bits) <= MAX_BUCKETS:
        raise ValueError(f"{len(bits)} width buckets; the kernel takes 1.."
                         f"{MAX_BUCKETS}")
    _check(ids, "ids", torch.int32, (ids.numel(),), dev)
    _check(table["width_idx"], "width_idx", torch.int32, (n,), dev)
    _check(table["local_idx"], "local_idx", torch.int32, (n,), dev)
    _check(table["alpha"], "alpha", torch.float32, (len(bits),), dev)
    _check(table["beta"], "beta", torch.float32, (d,), dev)
    ptrs, rows, widths = [], [], []
    for b in bits:
        if b == 0:
            ptrs.append(0)
            rows.append(0)
            widths.append(0)
            continue
        if not 1 <= b <= 31:
            raise ValueError(f"code width {b} outside the kernel's 1..31")
        sub = table["subtables"][f"b{b}"]
        if sub.ndim != 2 or sub.shape[0] < 1:
            raise ValueError(f"subtable b{b} must be a non-empty 2-D tensor")
        _check(sub, f"subtable b{b}", torch.int32,
               (sub.shape[0], words_per_row(d, b)), dev)
        ptrs.append(sub.data_ptr())
        rows.append(int(sub.shape[0]))
        widths.append(int(b))
    out = torch.empty((ids.numel(), d), dtype=torch.float32, device=dev)
    if ids.numel() == 0:
        return out
    m = len(bits)
    c_ptrs = (ctypes.c_longlong * m)(*ptrs)
    c_rows = (ctypes.c_int * m)(*rows)
    c_bits = (ctypes.c_int * m)(*widths)
    kernel = _kernel()
    with torch.cuda.device(dev):
        err = kernel(ids.data_ptr(), ids.numel(), n,
                     table["width_idx"].data_ptr(),
                     table["local_idx"].data_ptr(),
                     ctypes.addressof(c_ptrs), ctypes.addressof(c_rows),
                     ctypes.addressof(c_bits), m,
                     table["alpha"].data_ptr(), table["beta"].data_ptr(), d,
                     out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mpe_lookup kernel launch failed: CUDA error {err}")
    packed_lookup.launches += 1
    return out


def packed_lookup(table, meta, ids: torch.Tensor) -> torch.Tensor:
    """ids: global feature ids of any shape -> (*ids.shape, d) float32."""
    flat = ids.reshape(-1)
    if flat.device.type == "cuda":
        out = _launch(table, meta, flat)
    elif flat.device.type == "cpu":
        out = packed_lookup_ref(table, meta, flat)
    else:
        raise ValueError(f"packed_lookup runs on CUDA or the CPU, not on "
                         f"{flat.device}")
    return out.reshape(*ids.shape, meta["d"])


packed_lookup.launches = 0
