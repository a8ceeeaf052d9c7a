"""Plain PyTorch version of the KV-cache write: the oracle the CUDA kernel
of ``csrc/kv_cache_write.cu`` is held against, and the path CPU tensors
take. It is the reference's ``LM._cache_write`` and ``LM._requant_cache``
(``repro/models/lm/transformer.py:196-245``) in place: the start clamped
to [0, T - s] as ``dynamic_update_slice`` clamps it; for an int8 cache the
absmax scale (``max|v| * float32(1/127)``, the multiply jitted XLA makes
of the division by the constant, floored at 1e-8), re-seeded at length 0,
the running maximum otherwise; the valid prefix re-projected onto the new
grid only on rows whose scale grew (a row whose scale did not grow has
ratio 1, which leaves every code as it is); the new codes
``round(v / scale)`` clipped to ±127.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantizer import quantize_symmetric, requantize_int8

INV127 = 1.0 / 127.0     # rounded to float32 where it multiplies
MIN_SCALE = 1e-8


def write_starts(lens: torch.Tensor, b: int, t: int, s: int) -> torch.Tensor:
    """Each row's write start (B,): its length clamped to [0, T - s]."""
    return torch.clamp(lens.to(torch.int64).reshape(-1).expand(b), 0, t - s)


def kv_cache_write_ref(cache: torch.Tensor, scale: torch.Tensor | None,
                       vals: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """In place: ``vals`` (B, s, H, hd) into ``cache`` (B, T, H, hd) at
    each row's length ``lens`` (a 0-d tensor or (B,)); an int8 cache also
    updates ``scale`` (B, 1, H, 1) float32 in place. Returns ``cache``."""
    b, t = cache.shape[:2]
    s = vals.shape[1]
    starts = write_starts(lens, b, t, s)
    rows = torch.arange(b, device=cache.device)[:, None]
    cols = starts[:, None] + torch.arange(s, device=cache.device)[None, :]
    if cache.dtype != torch.int8:
        cache[rows, cols] = vals.to(cache.dtype)
        return cache
    vals32 = vals.to(torch.float32)
    inv = torch.tensor(INV127, dtype=torch.float32, device=cache.device)
    obs = torch.clamp_min(vals32.abs().amax(dim=(1, 3), keepdim=True) * inv,
                          MIN_SCALE)
    first = (lens.reshape(-1) == 0).reshape(-1, 1, 1, 1)
    fresh = torch.where(first, obs, torch.maximum(scale, obs))
    grew = (fresh > scale) & ~first                       # (B, 1, H, 1)
    prefix = (torch.arange(t, device=cache.device)[None, :, None, None]
              < lens.reshape(-1, 1, 1, 1))                # (B|1, T, 1, 1)
    moved = requantize_int8(cache, scale / fresh)
    cache.copy_(torch.where(grew & prefix, moved, cache))
    cache[rows, cols] = quantize_symmetric(vals32, fresh)
    scale.copy_(fresh)
    return cache
