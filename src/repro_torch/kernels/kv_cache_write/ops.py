"""Public wrapper of the KV-cache write: the CUDA kernel of
``csrc/kv_cache_write.cu`` for tensors on the card, the plain version
(``ref.py``) for tensors on the CPU.

On CUDA tensors it launches the kernel or raises; there is no fallback.
``kv_cache_write.launches`` counts kernel launches, and only those. The
lengths are read on the device, so one launch (or one CUDA-graph replay of
it) serves any lengths: nothing waits on the host.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import on_card, raw_stream
from repro_torch.kernels.build import load_library
from repro_torch.kernels.kv_cache_write.ref import kv_cache_write_ref

VAL_TYPES = {torch.bfloat16: 1, torch.float32: 2}
CACHE_TYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("kv_cache_write").kv_cache_write
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, i, p, p, i, i, i, i, i, i, p]
    fn.restype = i
    return fn


def as_lengths(lens, b: int, device) -> torch.Tensor:
    """Lengths as an int32 tensor on ``device``: one shared length (0-d)
    or one a row (B,)."""
    lens = torch.as_tensor(lens, device=device)
    if lens.ndim not in (0, 1) or (lens.ndim == 1 and lens.shape[0] != b):
        raise ValueError(f"lengths must be one shared length or ({b},), got "
                         f"{tuple(lens.shape)}")
    if lens.dtype != torch.int32:
        lens = lens.to(torch.int32)
    return lens


def _check(cache, scale, vals):
    if cache.ndim != 4 or vals.ndim != 4:
        raise ValueError(f"expected cache (B, T, H, hd) and values (B, s, H, "
                         f"hd), got {tuple(cache.shape)} and "
                         f"{tuple(vals.shape)}")
    b, t, h, hd = cache.shape
    if (vals.shape[0], vals.shape[2], vals.shape[3]) != (b, h, hd):
        raise ValueError(f"values {tuple(vals.shape)} do not fit the cache "
                         f"{tuple(cache.shape)}")
    if not 1 <= vals.shape[1] <= t:
        raise ValueError(f"{vals.shape[1]} new positions for a cache of {t}")
    if cache.dtype not in CACHE_TYPES:
        raise TypeError(f"cache: expected int8, bfloat16 or float32, got "
                        f"{cache.dtype}")
    if vals.dtype not in VAL_TYPES:
        raise TypeError(f"values: expected bfloat16 or float32, got "
                        f"{vals.dtype}")
    if (cache.dtype == torch.int8) != (scale is not None):
        raise ValueError("an int8 cache takes a scale, a float cache none")
    if scale is not None:
        if scale.dtype != torch.float32 or tuple(scale.shape) != (b, 1, h, 1):
            raise ValueError(f"scale: expected float32 ({b}, 1, {h}, 1), got "
                             f"{scale.dtype} {tuple(scale.shape)}")
    for what, x in (("values", vals), ("scale", scale)):
        if x is not None and x.device != cache.device:
            raise ValueError(f"{what} lie on {x.device}, the cache on "
                             f"{cache.device}")


def kv_cache_write(cache: torch.Tensor, scale: torch.Tensor | None,
                   vals: torch.Tensor, lens) -> torch.Tensor:
    """In place: ``vals`` (B, s, H, hd) into ``cache`` (B, T, H, hd; int8,
    bfloat16 or float32) at each row's length (``lens``: one shared length
    or (B,)); an int8 cache also keeps its running-absmax ``scale``
    (B, 1, H, 1) in place. Returns ``cache``."""
    _check(cache, scale, vals)
    b, t, h, hd = cache.shape
    lens = as_lengths(lens, b, cache.device)
    if cache.device.type == "cpu":
        return kv_cache_write_ref(cache, scale, vals, lens)
    if cache.device.type != "cuda":
        raise ValueError(f"kv_cache_write runs on CUDA or the CPU, not on "
                         f"{cache.device}")
    for what, x in (("cache", cache), ("scale", scale)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
    vals = vals.contiguous()
    dev = cache.device
    with on_card(dev):
        err = _kernel()(vals.data_ptr(), VAL_TYPES[vals.dtype],
                        cache.data_ptr(), CACHE_TYPES[cache.dtype],
                        None if scale is None else scale.data_ptr(),
                        lens.data_ptr(), int(lens.ndim == 1), b,
                        vals.shape[1], t, h, hd, raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"kv_cache_write launch failed: CUDA error {err}")
    kv_cache_write.launches += 1
    return cache


kv_cache_write.launches = 0
