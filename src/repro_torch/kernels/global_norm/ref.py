"""Plain PyTorch version of the global-norm clip's scale and norm: the
reference's ``clip_by_global_norm`` norm (``train/optimizer.py``), one
torch call per operation, the path CPU tensors take and the one the CUDA
pass of ``csrc/global_norm.cu`` is held against.

Each leaf is squared in float32 (a bfloat16 leaf widened first) into a new
tensor and summed; the leaves' sums are stacked and summed in float32.
Torch takes ``max_norm / x`` as ``reciprocal(x) * max_norm``, and
``clamp`` keeps a NaN: the pass forms both the same way.
"""
from __future__ import annotations

import torch


def global_norm_clip_ref(grads, max_norm: float):
    """``(scale, gnorm)`` of the gradient leaves ``grads`` (a list of
    tensors), as 0-d float32 tensors on their device."""
    sq = [torch.sum(torch.square(g.float())) for g in grads]
    gnorm = torch.sqrt(torch.sum(torch.stack(sq)))
    return torch.clamp(max_norm / (gnorm + 1e-12), max=1.0), gnorm
