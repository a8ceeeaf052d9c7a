"""Public wrapper of the global-norm clip's scale and norm: the CUDA pass of
``csrc/global_norm.cu`` for leaves on the card, the plain version
(``ref.py``) for leaves on the CPU.

On CUDA leaves it launches the pass or raises; there is no fallback.
``global_norm_clip.launches`` counts launches, and only those: one a call.
The pass writes into a scratch of ~68 KB that the wrapper makes once for
each device and stream, and allocates nothing gradient-sized.

Leaves are float32 or bfloat16 (widened to float32 before squaring, as the
plain version's ``g.float()`` does), contiguous, all on one card, and at
most ``MAX_LEAVES`` of them: one launch passes them all.

Under an op walk each call is one region (``repro_torch.kernels.region``)
charged its analytic cost; on meta tensors it returns two 0-d stand-ins.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import on_card, raw_stream
from repro_torch.kernels import region as _region
from repro_torch.kernels.build import load_library
from repro_torch.kernels.global_norm.ref import global_norm_clip_ref

TYPES = {torch.float32: 0, torch.bfloat16: 1}   # the pass's codes
MAX_LEAVES = 1024   # the pass's kMaxLeaves: leaves one launch takes

_SCRATCH: dict = {}   # (device index, stream) -> the zeroed scratch


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("global_norm")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.global_norm.argtypes = [p, p, p, i, p, ctypes.c_float, p, p]
    lib.global_norm.restype = i
    lib.global_norm_scratch_bytes.argtypes = [i]
    lib.global_norm_scratch_bytes.restype = ll
    lib.global_norm_max_leaves.argtypes = []
    lib.global_norm_max_leaves.restype = i
    if lib.global_norm_max_leaves() != MAX_LEAVES:
        raise RuntimeError(f"global_norm: the pass takes "
                           f"{lib.global_norm_max_leaves()} leaves, the "
                           f"wrapper checks for {MAX_LEAVES}")
    return lib


def _check(grads):
    """Raise on what the pass does not take: no leaf or more than
    ``MAX_LEAVES``, leaves that are not all on the first one's device, not
    float32 or bfloat16, or not contiguous."""
    if not grads:
        raise ValueError("global_norm_clip takes at least one leaf")
    if len(grads) > MAX_LEAVES:
        raise ValueError(f"global_norm_clip takes at most {MAX_LEAVES} leaves "
                         f"on the card, not {len(grads)}")
    dev = grads[0].device
    for i, g in enumerate(grads):
        if g.device != dev:
            raise ValueError(f"leaf {i} lies on {g.device}, leaf 0 on {dev}")
        if g.dtype not in TYPES:
            raise TypeError(f"leaf {i}: expected float32 or bfloat16, got "
                            f"{g.dtype}")
        if not g.is_contiguous():
            raise ValueError(f"leaf {i} must be contiguous")


def _scratch(dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None:
        n = _lib().global_norm_scratch_bytes(dev.index)
        if n <= 0:
            raise RuntimeError(f"global_norm: cannot size the scratch on {dev}")
        buf = _SCRATCH[key] = torch.zeros(n, dtype=torch.uint8, device=dev)
    return buf


def global_norm_clip(grads, max_norm: float):
    """``(scale, gnorm)`` of the gradient leaves ``grads`` (a list of
    tensors): ``gnorm = sqrt(Σ g²)`` over every element of every leaf and
    ``scale = min(1, max_norm / (gnorm + 1e-12))``, as 0-d float32
    tensors on the leaves' device. Non-finite where any element is, or
    where the squares' sum passes float32's range."""
    grads = list(grads)
    if _region.WALK is not None or (grads and grads[0].is_meta):
        return _region.run("global_norm", global_norm_clip, (grads, max_norm),
                           meta=bool(grads) and grads[0].is_meta,
                           shape=_shape, cost=cost)
    if grads and grads[0].device.type == "cpu":
        return global_norm_clip_ref(grads, max_norm)
    _check(grads)
    dev = grads[0].device
    if dev.type != "cuda":
        raise ValueError(f"global_norm_clip runs on CUDA or the CPU, not on "
                         f"{dev}")
    out = torch.empty(2, dtype=torch.float32, device=dev)
    stream = raw_stream(dev)
    with on_card(dev):
        _launch(grads, max_norm, _scratch(dev, stream), out, stream)
    return out[0], out[1]


def _launch(grads, max_norm, scratch, out, stream):
    """The pass's launch over ``grads`` into ``out`` (scale, gnorm)."""
    n = len(grads)
    ptrs = (ctypes.c_void_p * n)(*[g.data_ptr() for g in grads])
    counts = (ctypes.c_longlong * n)(*[g.numel() for g in grads])
    types = (ctypes.c_int * n)(*[TYPES[g.dtype] for g in grads])
    err = _lib().global_norm(ptrs, counts, types, n, scratch.data_ptr(),
                             float(max_norm), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"global_norm launch failed: CUDA error {err}")
    global_norm_clip.launches += 1


global_norm_clip.launches = 0


def _shape(grads, max_norm):
    dev = grads[0].device
    return (torch.empty((), dtype=torch.float32, device=dev),
            torch.empty((), dtype=torch.float32, device=dev))


def cost(grads, max_norm) -> dict:
    """The pass from shapes: every leaf read once, a multiply and an add an
    element; two floats written."""
    return {"flops": 2 * sum(g.numel() for g in grads),
            "bytes": _region.nbytes(*grads) + 8}
