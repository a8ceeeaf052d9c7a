"""Public wrapper of decode attention: the CUDA kernels of
``csrc/decode_attention.cu`` for tensors on the card, the plain version
(``ref.py``) for tensors on the CPU.

On CUDA tensors it launches the kernels (scores, sums, values and, where
the keys span more than one chunk, combine: one launch in the count) or
raises; there is no fallback. ``decode_attention.launches`` counts those
launches, and only those. Offsets and lengths are read on the device, so a
CUDA graph that holds the launch serves any lengths. The wrapper allocates
the float32 scratch: the logits (B·S·Hq, T), two (B·S·Hq, chunks) row
statistics and the (chunks, B·S·Hq, hd) partial outputs.

Under an op walk each call is one region (``repro_torch.kernels.region``)
charged its analytic cost; on meta tensors it returns empties of the
kernel's output shapes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import on_card, raw_stream
from repro_torch.kernels import region as _region
from repro_torch.kernels.build import load_library
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.kv_cache_write.ops import as_lengths

Q_TYPES = {torch.bfloat16: 1, torch.float32: 2}
CACHE_TYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
HEAD_DIMS = (16, 32, 64, 128)   # the widths csrc/decode_attention.cu takes


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("decode_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_attention.argtypes = [p, i, p, p, i, p, p, p, i, p, i, i, i,
                                     i, i, i, i, f, i, p, p, p, p, p, p]
    lib.decode_attention.restype = i
    lib.decode_attention_chunk.restype = i
    return lib


def _check(q, k, v, k_scale, v_scale):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, S, Hq, hd) and k, v (B, T, Hkv, "
                         f"hd), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, hq, hd = q.shape
    if (k.shape[0], k.shape[3]) != (b, hd) or hq % k.shape[2]:
        raise ValueError(f"k {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if q.dtype not in Q_TYPES:
        raise TypeError(f"q: expected bfloat16 or float32, got {q.dtype}")
    if k.dtype not in CACHE_TYPES or v.dtype != k.dtype:
        raise TypeError(f"k, v: expected int8, bfloat16 or float32, got "
                        f"{k.dtype}, {v.dtype}")
    quant = k.dtype == torch.int8
    if quant != (k_scale is not None and v_scale is not None):
        raise ValueError("an int8 cache takes its scales, a float cache none")
    if quant:
        want = (b, 1, k.shape[2], 1)
        for what, x in (("k_scale", k_scale), ("v_scale", v_scale)):
            if x.dtype != torch.float32 or tuple(x.shape) != want:
                raise ValueError(f"{what}: expected float32 {want}, got "
                                 f"{x.dtype} {tuple(x.shape)}")
    for what, x in (("k", k), ("v", v), ("k_scale", k_scale),
                    ("v_scale", v_scale)):
        if x is not None and x.device != q.device:
            raise ValueError(f"{what} lies on {x.device}, q on {q.device}")


def decode_attention(q, k, v, k_scale=None, v_scale=None, *, q_offset,
                     kv_valid_len, causal: bool = True) -> torch.Tensor:
    """q (B, S, Hq, hd) bf16 or float32; k, v (B, T, Hkv, hd) int8 with
    their scales (B, 1, Hkv, 1), or bf16 or float32 -> (B, S, Hq, hd) in
    q's dtype: grouped-query attention of each query row i over the keys
    ``t < kv_valid_len`` and (causal) ``t <= q_offset + i``; offsets and
    lengths one shared value or one a row (B,)."""
    if _region.WALK is not None or q.is_meta:
        return _region.run("decode_attention", decode_attention,
                           (q, k, v, k_scale, v_scale),
                           {"q_offset": q_offset,
                            "kv_valid_len": kv_valid_len, "causal": causal},
                           meta=q.is_meta,
                           shape=lambda q, *_, **__: torch.empty_like(q),
                           cost=cost)
    _check(q, k, v, k_scale, v_scale)
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    off = as_lengths(q_offset, b, q.device)
    valid = as_lengths(kv_valid_len, b, q.device)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, k_scale, v_scale, off, valid,
                                    causal)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on CUDA or the CPU, not on "
                         f"{q.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"hd={hd}: the kernel takes {HEAD_DIMS}")
    for what, x in (("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{what} must be 16-byte aligned")
    q = q.contiguous()
    lib = _library()
    chunks = -(-t // lib.decode_attention_chunk())
    rows = b * s * hq
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    logits = torch.empty((rows, t), **f32)
    cmax = torch.empty((rows, chunks), **f32)
    csum = torch.empty((rows, chunks), **f32)
    part = torch.empty((chunks if chunks > 1 else 0, rows, hd), **f32)
    out = torch.empty_like(q)
    quant = k.dtype == torch.int8
    with on_card(dev):
        err = lib.decode_attention(
            q.data_ptr(), Q_TYPES[q.dtype], k.data_ptr(), v.data_ptr(),
            CACHE_TYPES[k.dtype], k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None, off.data_ptr(),
            int(off.ndim == 1), valid.data_ptr(), int(valid.ndim == 1), b, s,
            hq, hkv, t, hd, hd ** -0.5, int(causal), logits.data_ptr(),
            cmax.data_ptr(), csum.data_ptr(), part.data_ptr(),
            out.data_ptr(), raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def cost(q, k, v, k_scale=None, v_scale=None, **_) -> dict:
    """Attention from shapes, over every cached key (the valid lengths are
    data): q·kᵀ and p·v, 2·hd operations each a (query, key) pair; the
    caches and their scales read once, q read, the output written."""
    b, s, hq, hd = q.shape
    t = k.shape[1]
    return {"flops": 4 * b * s * hq * t * hd,
            "bytes": _region.nbytes(q, k, v, k_scale, v_scale, q)}
