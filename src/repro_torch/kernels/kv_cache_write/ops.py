"""Public wrappers of the KV-cache write: the CUDA kernels of
``csrc/kv_cache_write.cu`` for tensors on the card, the plain version
(``ref.py``) for tensors on the CPU.

``kv_cache_write`` writes one cache, ``kv_cache_write_kv`` a layer's keys
and values in one call: one kernel launch at decode (``s * hd <=
SMALL_WORK``), two over the positions of a longer write into int8 caches
(the scales, then the codes), one into float caches. On CUDA tensors they
launch or raise; there is no fallback. ``kv_cache_write.launches`` counts
kernel launches of both, and only those. The lengths are read on the
device, so one launch (or one CUDA-graph replay of it) serves any lengths:
nothing waits on the host.

Under an op walk each call is one region (``repro_torch.kernels.region``)
charged its analytic cost; on meta tensors it returns the caches unwritten.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import on_card, raw_stream
from repro_torch.kernels import region as _region
from repro_torch.kernels.build import load_library
from repro_torch.kernels.kv_cache_write.ref import kv_cache_write_ref

VAL_TYPES = {torch.bfloat16: 1, torch.float32: 2}
CACHE_TYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
SMALL_WORK = 4096   # kSmallWork in csrc/kv_cache_write.cu: s * hd at decode


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = load_library("kv_cache_write")
    if lib.kv_cache_write_small_work() != SMALL_WORK:
        raise RuntimeError("csrc/kv_cache_write.cu's kSmallWork and "
                           "SMALL_WORK differ")
    fn = lib.kv_cache_write
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, p, p, i, p, p, i, p, p, p, i, p, i, i, i, i, i, p]
    fn.restype = i
    return fn


def kernels_a_call(s: int, hd: int, cache_dtype) -> int:
    """Kernel launches one write of ``s`` positions makes on the card,
    for one cache or for keys and values together."""
    return 2 if cache_dtype == torch.int8 and s * hd > SMALL_WORK else 1


@functools.lru_cache(maxsize=None)
def _scratch(device_index: int, slots: int) -> torch.Tensor:
    """The int8 route's scratch (tickets, maxima, kept scales; ``slots``
    int32 each), one per card and size, zero when made and left zero by
    every launch."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("kv_cache_write: call it once before a CUDA-graph "
                           "capture, which cannot zero its scratch")
    return torch.zeros((3 * slots,), dtype=torch.int32,
                       device=torch.device("cuda", device_index))


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
    return _write(((cache, scale, vals),), lens)[0]


def kv_cache_write_kv(k_cache: torch.Tensor, k_scale: torch.Tensor | None,
                      k: torch.Tensor, v_cache: torch.Tensor,
                      v_scale: torch.Tensor | None, v: torch.Tensor, lens):
    """A layer's keys and values, as ``kv_cache_write`` writes each, in one
    call (one launch at decode): the plain version writes the keys, then
    the values. The caches share shape and type, the values too. Returns
    (k_cache, v_cache)."""
    if (k_cache.shape != v_cache.shape or k_cache.dtype != v_cache.dtype
            or k.shape != v.shape or k.dtype != v.dtype):
        raise ValueError(f"keys and values differ: caches "
                         f"{tuple(k_cache.shape)} {k_cache.dtype} and "
                         f"{tuple(v_cache.shape)} {v_cache.dtype}, values "
                         f"{tuple(k.shape)} {k.dtype} and {tuple(v.shape)} "
                         f"{v.dtype}")
    return _write(((k_cache, k_scale, k), (v_cache, v_scale, v)), lens)


def _write(writes, lens) -> tuple:
    cache0 = writes[0][0]
    if _region.WALK is not None or cache0.is_meta:
        return _region.run("kv_cache_write", _write, (writes, lens),
                           meta=cache0.is_meta,
                           shape=lambda w, _: tuple(c for c, _, _ in w),
                           cost=cost)
    for cache, scale, vals in writes:
        _check(cache, scale, vals)
    cache = writes[0][0]
    b, t, h, hd = cache.shape
    lens = as_lengths(lens, b, cache.device)
    if cache.device.type == "cpu":
        return tuple(kv_cache_write_ref(c, sc, x, lens) for c, sc, x in writes)
    if cache.device.type != "cuda":
        raise ValueError(f"kv_cache_write runs on CUDA or the CPU, not on "
                         f"{cache.device}")
    for c, sc, _ in writes:
        for what, x in (("cache", c), ("scale", sc)):
            if x is not None and not x.is_contiguous():
                raise ValueError(f"{what} must be contiguous")
    s = writes[0][2].shape[1]
    pair = [(c, sc, x.contiguous()) for c, sc, x in writes]
    (c0, s0, x0), (c1, s1, x1) = pair + [(None, None, None)] * (2 - len(pair))
    dev = cache.device
    with on_card(dev):
        scratch = (_scratch(dev.index, len(writes) * b * h)
                   if cache.dtype == torch.int8 else None)
        ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
        err = _kernel()(len(writes), ptr(x0), ptr(x1), VAL_TYPES[x0.dtype],
                        ptr(c0), ptr(c1), CACHE_TYPES[c0.dtype], ptr(s0),
                        ptr(s1), lens.data_ptr(), int(lens.ndim == 1),
                        ptr(scratch), b, s, t, h, hd, raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"kv_cache_write launch failed: CUDA error {err}")
    kv_cache_write.launches += kernels_a_call(s, hd, cache.dtype)
    return tuple(c for c, _, _ in writes)


kv_cache_write.launches = 0


def cost(writes, lens) -> dict:
    """The write from shapes: each value read and written at its position
    in the cache (an int8 cache also reads and writes its scales, and
    quantizes: ~4 operations an element). A scale that grows rewrites the
    cache's valid prefix; that depends on the values and is not counted."""
    flops = nb = 0
    for cache, scale, vals in writes:
        n = vals.numel()
        nb += n * (vals.element_size() + cache.element_size())
        if scale is not None:
            nb += 2 * _region.nbytes(scale)
            flops += 4 * n
    return {"flops": flops, "bytes": nb}
