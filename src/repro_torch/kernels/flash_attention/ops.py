"""Public wrappers of the flash-attention kernels of
``csrc/flash_attention.cu``, and ``flash_attention`` on (B, S, H, hd).

The kernels take the models' own layout, (B, S, H, hd) with lse (B, H, S),
so ``flash_attention`` hands q, k and v over as they come and gets o back in
that layout: no transposed copy on the CUDA path. The wrappers also take the
reference kernels' (B·H, S, hd) layout with lse (B·H, S), the H = 1 case of
the same call.

``flash_attention`` is differentiable: where a gradient is wanted, one
``torch.autograd.Function`` runs the forward with its logsumexp rows and
saves q, k, v, o and lse, and its backward runs the backward kernel, which
forms ``delta = rowsum(do·o)`` itself; under ``torch.no_grad()`` (serving)
the plain forward runs and writes no logsumexp rows. This is the
reference's ``custom_vjp`` in ``kernels/flash_attention/ops.py``.

On CUDA tensors each wrapper launches its kernel or raises; there is no
fallback. CPU tensors take the plain versions of ``ref.py``, on
(B·H, S, hd). ``flash_attention_fwd.launches``,
``flash_attention_fwd_stats.launches`` and ``flash_attention_bwd.launches``
count kernel launches, and only those.

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
from repro_torch.kernels.flash_attention.ref import (bwd_ref,
                                                     flash_attention_ref,
                                                     fwd_stats_ref)

MAX_HEAD_DIM = 128   # kMaxHeadDim in csrc/flash_attention.cu
MAX_STAGED = 64      # kMaxStaged: the longest S of the staged route
BLOCK = 128          # the reference's bq = bk, capped at S


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("flash_attention")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.flash_attention_fwd.argtypes = [p, p, p, ll, i, i, i, f, i, p, p, p]
    lib.flash_attention_fwd.restype = i
    lib.flash_attention_bwd.argtypes = [p, p, p, p, p, p, ll, i, i, i, f, i,
                                        p, p, p, p, p]
    lib.flash_attention_bwd.restype = i
    return lib


def _rows_shape(q) -> tuple:
    """The shape of lse for q: (BH, S) for (BH, S, hd), (B, H, S) for
    (B, S, H, hd)."""
    return tuple(q.shape[:2]) if q.ndim == 3 else (q.shape[0], q.shape[2],
                                                   q.shape[1])


def _check(q, **others):
    """Raise on what the wrappers do not take: (BH, S, hd) or (B, S, H, hd)
    with S that the reference's blocks divide (S <= 128 or a multiple of
    128); on CUDA also float32, contiguous, hd <= 128, every tensor on q's
    device with the shape it must have."""
    if q.ndim not in (3, 4):
        raise ValueError(f"q must be (BH, S, hd) or (B, S, H, hd), got "
                         f"{tuple(q.shape)}")
    s, hd = q.shape[1], q.shape[-1]
    if s % min(BLOCK, s) != 0:
        raise ValueError(f"S={s}: the reference's blocks of {BLOCK} must "
                         f"divide it")
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise ValueError(f"flash attention runs on CUDA or the CPU, not "
                             f"on {q.device}")
        return
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"hd={hd} outside the kernels' 1..{MAX_HEAD_DIM}")
    card = q.get_device()
    for what, x in (("q", q), *others.items()):
        want = _rows_shape(q) if what == "lse" else q.shape
        if x.get_device() != card:
            raise ValueError(f"{what} lies on {x.device}, q on {q.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{what}: expected torch.float32, got {x.dtype}")
        if x.shape != want:
            raise ValueError(f"{what}: expected shape {tuple(want)}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{what} must be contiguous")


def _bshd(q) -> tuple:
    """(B, S, H, hd) of q; (BH, S, hd) is the H = 1 case."""
    return (q.shape[0], q.shape[1], 1, q.shape[2]) if q.ndim == 3 else tuple(q.shape)


def _heads_first(x):
    """CPU path: (B, S, H, hd) -> (B·H, S, hd); lse (B, H, S) -> (B·H, S)."""
    if x.ndim == 4:
        b, s, h, hd = x.shape
        return x.transpose(1, 2).reshape(b * h, s, hd)
    return x.reshape(-1, x.shape[-1])


def _plain(fn, q, *tensors, causal):
    """``fn`` of ``ref.py`` on (B·H, S, hd), its outputs in q's layout."""
    if q.ndim == 3:
        return fn(q, *tensors, causal)
    b, s, h, hd = q.shape
    out = fn(*(_heads_first(x) for x in (q, *tensors)), causal)
    back = [x.reshape(b, h, s, hd).transpose(1, 2) if x.ndim == 3
            else x.reshape(b, h, s) for x in (out if isinstance(out, tuple)
                                              else (out,))]
    return tuple(back) if isinstance(out, tuple) else back[0]


def _on_device(x, fn, *args):
    """``fn(*args, stream)`` with x's card current and its current stream
    (the device guard only where another card is current)."""
    card = x.get_device()
    if card == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(card):
        return fn(*args, torch.cuda.current_stream().cuda_stream)


def _forward(q, k, v, causal: bool, lse) -> torch.Tensor:
    b, s, h, hd = _bshd(q)
    o = torch.empty_like(q)
    err = _on_device(q, _library().flash_attention_fwd, q.data_ptr(),
                     k.data_ptr(), v.data_ptr(), b, s, h, hd, hd ** -0.5,
                     int(causal), o.data_ptr(),
                     None if lse is None else lse.data_ptr())
    if err != 0:
        raise RuntimeError(f"flash attention forward launch failed: CUDA "
                           f"error {err}")
    return o


def flash_attention_fwd(q, k, v, causal: bool = True) -> torch.Tensor:
    """Forward, no logsumexp rows: o in q's layout."""
    if _region.WALK is not None or q.is_meta:
        return _region.run("flash_attention_fwd", flash_attention_fwd,
                           (q, k, v, causal), meta=q.is_meta,
                           shape=lambda q, *_: torch.empty_like(q),
                           cost=fwd_cost)
    _check(q, k=k, v=v)
    if not q.is_cuda:
        return _plain(flash_attention_ref, q, k, v, causal=causal)
    o = _forward(q, k, v, causal, None)
    flash_attention_fwd.launches += 1
    return o


def flash_attention_fwd_stats(q, k, v, causal: bool = True):
    """Forward with the logsumexp rows: (o in q's layout, lse (BH, S) or
    (B, H, S))."""
    if _region.WALK is not None or q.is_meta:
        return _region.run("flash_attention_fwd_stats",
                           flash_attention_fwd_stats, (q, k, v, causal),
                           meta=q.is_meta, shape=_stats_shape,
                           cost=fwd_stats_cost)
    _check(q, k=k, v=v)
    if not q.is_cuda:
        return _plain(fwd_stats_ref, q, k, v, causal=causal)
    lse = torch.empty(_rows_shape(q), dtype=torch.float32, device=q.device)
    o = _forward(q, k, v, causal, lse)
    flash_attention_fwd_stats.launches += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True):
    """Backward from the stored ``lse``: (dq, dk, dv) in q's layout. The
    kernels form ``delta = rowsum(do·o)`` once a row (the tiled route into
    a (B, H, S) scratch this wrapper allocates); the reference forms the
    same sum outside its kernel."""
    if _region.WALK is not None or q.is_meta:
        return _region.run("flash_attention_bwd", flash_attention_bwd,
                           (q, k, v, o, lse, do, causal), meta=q.is_meta,
                           shape=lambda q, *_: tuple(torch.empty_like(q)
                                                     for _ in range(3)),
                           cost=bwd_cost)
    _check(q, k=k, v=v, o=o, lse=lse, do=do)
    if not q.is_cuda:
        return _plain(bwd_ref, q, k, v, o, lse, do, causal=causal)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    b, s, h, hd = _bshd(q)
    # the tiled route's delta rows, written by its dQ kernel, read by its
    # dK/dV kernel
    delta = (torch.empty(_rows_shape(q), dtype=torch.float32, device=q.device)
             if s > MAX_STAGED else None)
    err = _on_device(q, _library().flash_attention_bwd, q.data_ptr(),
                     k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                     lse.data_ptr(), b, s, h, hd, hd ** -0.5, int(causal),
                     dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                     None if delta is None else delta.data_ptr())
    if err != 0:
        raise RuntimeError(f"flash attention backward launch failed: CUDA "
                           f"error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_fwd.launches = 0
flash_attention_fwd_stats.launches = 0
flash_attention_bwd.launches = 0


def _stats_shape(q, k, v, causal=True):
    return torch.empty_like(q), torch.empty(_rows_shape(q),
                                            dtype=torch.float32,
                                            device=q.device)


def _pairs(s: int, causal: bool) -> int:
    """(query, key) pairs a head attends: S² or, causal, S(S + 1)/2."""
    return s * (s + 1) // 2 if causal else s * s


def fwd_cost(q, k, v, causal=True) -> dict:
    """The forward from shapes: q·kᵀ and p·v, 2·hd operations each a
    (query, key) pair; q, k, v read, o written."""
    b, s, h, hd = _bshd(q)
    return {"flops": 4 * b * h * hd * _pairs(s, causal),
            "bytes": _region.nbytes(q, k, v, q)}


def fwd_stats_cost(q, k, v, causal=True) -> dict:
    """``fwd_cost`` and the float32 lse rows written."""
    b, s, h, _ = _bshd(q)
    cost = fwd_cost(q, k, v, causal)
    cost["bytes"] += 4 * b * h * s
    return cost


def bwd_cost(q, k, v, o, lse, do, causal=True) -> dict:
    """The backward from shapes: five products of 2·hd operations a pair
    (the scores again, dv, dp, dq, dk); q, k, v, o, do, lse read, dq, dk,
    dv written."""
    b, s, h, hd = _bshd(q)
    return {"flops": 10 * b * h * hd * _pairs(s, causal),
            "bytes": _region.nbytes(q, k, v, o, lse, do, q, k, v)}


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


def flash_attention(q, k, v, *, n_kv_heads: int | None = None,
                    causal: bool = True) -> torch.Tensor:
    """q (B, S, Hq, hd); k, v (B, S, Hkv, hd) -> (B, S, Hq, hd). Grouped
    queries repeat each kv head Hq/Hkv times, as the reference does."""
    hq, hkv = q.shape[2], k.shape[2]
    if n_kv_heads is not None and n_kv_heads != hkv:
        raise ValueError(f"n_kv_heads={n_kv_heads}, but k has {hkv} heads")
    if hkv != hq:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    q, k, v = (x.contiguous() for x in (q, k, v))
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal)
    return flash_attention_fwd(q, k, v, causal)


# the reference's name; its ``interpret=`` (the Pallas interpreter) and
# block sizes ``bq``/``bk`` are not taken: a CUDA tensor takes the kernel,
# which picks its own tiles, a CPU tensor the plain version
flash_attention_kernel = flash_attention


def flash_attention_kernel_sharded(q, k, v, *, n_kv_heads: int | None = None,
                                   causal: bool = True, head_axes=("model",),
                                   mesh=None) -> torch.Tensor:
    """Flash attention on a mesh: batch over the data axes, heads over
    ``head_axes`` — each (batch, head) pair on one rank, bit-exact against
    the single-device kernels, forward and backward. ``flash_attention``
    when no mesh of more than one rank is active (see
    ``repro_torch.dist.shard``)."""
    from repro_torch.dist.shard import sharded_flash_attention
    return sharded_flash_attention(q, k, v, n_kv_heads=n_kv_heads,
                                   causal=causal, head_axes=head_axes,
                                   mesh=mesh)
