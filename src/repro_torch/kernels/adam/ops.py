"""Public wrapper of the in-place Adam step of one leaf: the CUDA pass of
``csrc/adam.cu`` for tensors on the card, the plain version (``ref.py``)
for tensors on the CPU.

On CUDA tensors it launches the pass or raises; there is no fallback.
``adam_step_.launches`` counts launches, and only those. The step's
constants go to the pass as the float32 values torch computes with (a
Python float times a float32 tensor is taken in float32). ``lr`` is a
Python float, or a schedule's value: a 0-d float32 tensor on the leaf's
device, which the pass reads there (no step waits for the host).

A leaf and its gradient are float32 (moments float32 or bfloat16), or
bfloat16 with float32 moments, the reference's dtypes for a bfloat16 leaf
from its first update on (``ref.py`` says how such a step rounds).

Under an op walk each call is one region (``repro_torch.kernels.region``)
charged its analytic cost; on meta tensors it writes nothing.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels.adam.ref import adam_step_ref_, decay_factor
from repro_torch.kernels import region as _region
from repro_torch.kernels.build import load_library

TYPES = {torch.float32: 0, torch.bfloat16: 1}   # the pass's codes, leaf and moments


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("adam").adam_step
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn.argtypes = [p, p, p, p, ll, i, i, p, p, p, p, p, f, f, f, f, f, f, f,
                   f, i, p]
    fn.restype = i
    return fn


def _f32(x: float) -> float:
    """The float32 value torch takes a Python float scalar as."""
    return float(np.float32(x))


def _check(p, g, m, v, scale, ok, bc1, bc2, lr):
    """Raise on what the pass does not take: a leaf p and its gradient g
    both float32 with moments m, v both float32 or both bfloat16, or both
    bfloat16 with float32 moments; all of one shape and contiguous; float32
    0-d scale, bc1, bc2 (and lr, if it is a tensor) and a bool 0-d ok, all
    on p's device."""
    if p.dtype not in TYPES:
        raise TypeError(f"p must be float32 or bfloat16, got {p.dtype}")
    if m.dtype not in TYPES or v.dtype != m.dtype:
        raise TypeError(f"moments must both be float32 or bfloat16, got "
                        f"{m.dtype} and {v.dtype}")
    if p.dtype == torch.bfloat16 and m.dtype != torch.float32:
        raise TypeError(f"a bfloat16 leaf takes float32 moments, got "
                        f"{m.dtype}")
    named = {"p": (p, p.dtype), "g": (g, p.dtype),
             "m": (m, m.dtype), "v": (v, m.dtype)}
    for what, (x, dtype) in named.items():
        if x.device != p.device:
            raise ValueError(f"{what} lies on {x.device}, p on {p.device}")
        if x.dtype != dtype:
            raise TypeError(f"{what}: expected {dtype}, got {x.dtype}")
        if tuple(x.shape) != tuple(p.shape):
            raise ValueError(f"{what}: expected shape {tuple(p.shape)}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
    scalars = [("scale", scale, torch.float32), ("ok", ok, torch.bool),
               ("bc1", bc1, torch.float32), ("bc2", bc2, torch.float32)]
    if torch.is_tensor(lr):
        scalars.append(("lr", lr, torch.float32))
    for what, x, dtype in scalars:
        if x.device != p.device or x.dtype != dtype or x.numel() != 1:
            raise ValueError(f"{what} must be one {dtype} on {p.device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")


def adam_step_(p, g, m, v, scale, ok, bc1, bc2, *, lr, b1, b2, eps,
               weight_decay) -> None:
    """In place: ``p``, ``m`` and ``v`` take one Adam step with the gradient
    ``g * scale`` where the 0-d bool ``ok`` holds; where it does not, all
    three keep their bits. ``lr``: a float or a 0-d float32 tensor."""
    if _region.WALK is not None or p.is_meta:
        return _region.run("adam_step_", adam_step_,
                           (p, g, m, v, scale, ok, bc1, bc2),
                           {"lr": lr, "b1": b1, "b2": b2, "eps": eps,
                            "weight_decay": weight_decay}, meta=p.is_meta,
                           shape=lambda *a, **k: None, cost=cost)
    hyper = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if p.device.type == "cpu":
        adam_step_ref_(p, g, m, v, scale, ok, bc1, bc2, **hyper)
        return
    if p.device.type != "cuda":
        raise ValueError(f"adam_step_ runs on CUDA or the CPU, not on {p.device}")
    _check(p, g, m, v, scale, ok, bc1, bc2, lr)
    f32 = _f32
    decay = bool(weight_decay) and p.ndim > 1
    if torch.is_tensor(lr):   # a schedule's lr_t: the pass forms lr_t·wd
        lr_ptr, neg_lr, lr_wd = lr.data_ptr(), 0.0, 0.0
    else:
        lr_ptr, neg_lr = None, f32(-lr)
        lr_wd = decay_factor(lr, weight_decay, p.dtype) if decay else 0.0
    with torch.cuda.device(p.device):
        err = _kernel()(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
            TYPES[p.dtype], TYPES[m.dtype], scale.data_ptr(), ok.data_ptr(),
            bc1.data_ptr(), bc2.data_ptr(), lr_ptr, neg_lr, f32(b1),
            f32(1 - b1), f32(b2), f32(1 - b2), f32(eps), lr_wd,
            f32(weight_decay), int(decay),
            torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"adam step launch failed: CUDA error {err}")
    adam_step_.launches += 1


adam_step_.launches = 0


def cost(p, g, m, v, *_, **__) -> dict:
    """The pass from shapes: p, g, m and v read, p, m and v written, ~12
    operations an element (moments, bias corrections, the step, decay)."""
    return {"flops": 12 * p.numel(),
            "bytes": _region.nbytes(p, g, m, v, p, m, v)}
