"""Plain PyTorch version of the gather's backward: ``F.embedding``'s dense
backward (``aten.embedding_dense_backward``) taken in float64 and rounded
once, the path CPU tensors take and the oracle the CUDA kernel of
``csrc/segment_sum.cu`` is held against. Float32 sums of a hot row's
million contributions, taken in two orders, part by more than a float32
step; float64 ones round to the same float32 nearly always.
"""
from __future__ import annotations

import torch


def segment_sum_ref(grad: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """grad (T, w), ids (T,) in [0, n) -> (n, w) float32: row i is the sum of
    the rows of ``grad`` whose id is i (0 where there is none)."""
    return torch.ops.aten.embedding_dense_backward(
        grad.double(), ids.long(), n, -1, False).to(grad.dtype)
