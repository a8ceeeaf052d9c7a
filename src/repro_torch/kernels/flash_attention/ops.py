"""Public wrappers of the flash-attention kernels of
``csrc/flash_attention.cu``, on the kernels' (B·H, S, hd) layout, and
``flash_attention`` on (B, S, H, hd).

``flash_attention`` is differentiable: where a gradient is wanted, one
``torch.autograd.Function`` runs the forward with its logsumexp rows and
saves q, k, v, o and lse, and its backward forms ``delta = rowsum(do·o)``
and runs the backward kernel; under ``torch.no_grad()`` (serving) the plain
forward runs and writes no logsumexp rows. This is the reference's
``custom_vjp`` in ``kernels/flash_attention/ops.py``.

On CUDA tensors each wrapper launches its kernel or raises; there is no
fallback. CPU tensors take the plain versions of ``ref.py``.
``flash_attention_fwd.launches``, ``flash_attention_fwd_stats.launches`` and
``flash_attention_bwd.launches`` count kernel launches, and only those.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.flash_attention.ref import (bwd_ref,
                                                     flash_attention_ref,
                                                     fwd_stats_ref)

MAX_HEAD_DIM = 128   # kMaxHeadDim in csrc/flash_attention.cu
BLOCK = 128          # the reference's bq = bk, capped at S


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("flash_attention")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.flash_attention_fwd.argtypes = [p, p, p, ll, i, i, f, i, p, p, p]
    lib.flash_attention_fwd.restype = i
    lib.flash_attention_bwd.argtypes = [p, p, p, p, p, p, ll, i, i, f, i,
                                        p, p, p, p]
    lib.flash_attention_bwd.restype = i
    return lib


def _check(q, **others):
    """Raise on what the wrappers do not take: (BH, S, hd) with S that the
    reference's blocks divide (S <= 128 or a multiple of 128); on CUDA also
    float32, contiguous, hd <= 128, every tensor on q's device with the
    shape it must have."""
    if q.ndim != 3:
        raise ValueError(f"q must be (BH, S, hd), got {tuple(q.shape)}")
    bh, s, hd = q.shape
    if s % min(BLOCK, s) != 0:
        raise ValueError(f"S={s}: the reference's blocks of {BLOCK} must "
                         f"divide it")
    if q.device.type == "cpu":
        return
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CUDA or the CPU, not on "
                         f"{q.device}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"hd={hd} outside the kernels' 1..{MAX_HEAD_DIM}")
    for what, x in {"q": q, **others}.items():
        want = (bh, s) if what in ("lse", "delta") else (bh, s, hd)
        if x.device != q.device:
            raise ValueError(f"{what} lies on {x.device}, q on {q.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{what}: expected torch.float32, got {x.dtype}")
        if tuple(x.shape) != want:
            raise ValueError(f"{what}: expected shape {want}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{what} must be contiguous")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _forward(q, k, v, causal: bool, lse) -> torch.Tensor:
    bh, s, hd = q.shape
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _library().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bh, s, hd, hd ** -0.5,
            int(causal), o.data_ptr(), None if lse is None else lse.data_ptr(),
            _stream(q))
    if err != 0:
        raise RuntimeError(f"flash attention forward launch failed: CUDA "
                           f"error {err}")
    return o


def flash_attention_fwd(q, k, v, causal: bool = True) -> torch.Tensor:
    """Forward, no logsumexp rows: o (BH, S, hd)."""
    _check(q, k=k, v=v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal)
    o = _forward(q, k, v, causal, None)
    flash_attention_fwd.launches += 1
    return o


def flash_attention_fwd_stats(q, k, v, causal: bool = True):
    """Forward with the logsumexp rows: (o (BH, S, hd), lse (BH, S))."""
    _check(q, k=k, v=v)
    if q.device.type == "cpu":
        return fwd_stats_ref(q, k, v, causal)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    o = _forward(q, k, v, causal, lse)
    flash_attention_fwd_stats.launches += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True):
    """Backward from the stored ``lse``: (dq, dk, dv), each (BH, S, hd).
    ``delta = rowsum(do·o)`` is formed here, outside the kernel, as the
    reference forms it."""
    _check(q, k=k, v=v, o=o, lse=lse, do=do)
    if q.device.type == "cpu":
        return bwd_ref(q, k, v, o, lse, do, causal)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    bh, s, hd = q.shape
    delta = torch.sum(do * o, dim=-1)
    with torch.cuda.device(q.device):
        err = _library().flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), bh, s, hd, hd ** -0.5,
            int(causal), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _stream(q))
    if err != 0:
        raise RuntimeError(f"flash attention backward launch failed: CUDA "
                           f"error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_fwd.launches = 0
flash_attention_fwd_stats.launches = 0
flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd_stats(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal)
        return dq, dk, dv, None


def _flat(x, b, s, h, hd):
    return x.transpose(1, 2).reshape(b * h, s, hd).contiguous()


def flash_attention(q, k, v, *, n_kv_heads: int | None = None,
                    causal: bool = True) -> torch.Tensor:
    """q (B, S, Hq, hd); k, v (B, S, Hkv, hd) -> (B, S, Hq, hd). Grouped
    queries repeat each kv head Hq/Hkv times, as the reference does."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    if n_kv_heads is not None and n_kv_heads != hkv:
        raise ValueError(f"n_kv_heads={n_kv_heads}, but k has {hkv} heads")
    if hkv != hq:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    qf, kf, vf = (_flat(x, b, s, hq, hd) for x in (q, k, v))
    if torch.is_grad_enabled() and any(x.requires_grad for x in (qf, kf, vf)):
        of = _FlashAttention.apply(qf, kf, vf, causal)
    else:
        of = flash_attention_fwd(qf, kf, vf, causal)
    return of.reshape(b, hq, s, hd).transpose(1, 2)
