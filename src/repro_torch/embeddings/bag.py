"""EmbeddingBag, as the reference's ``embeddings/bag.py`` computes it.

Multi-hot bags are padded: ids (B, L) with a validity mask (B, L).
``embedding_bag`` with ``combine="sum"`` or ``"mean"`` goes through
``kernels.embedding_bag_kernel`` (the CUDA kernel on the card), which never
writes the (B, L, d) gather; ``"max"``, which no TPU kernel computes, and
``reduce_bag`` over rows already gathered stay plain PyTorch.

The ragged form (``ragged_embedding_bag``, ``segment_mean``) is the
reference's ``segment_sum``/``segment_max``. Here it is a stable sort by
segment followed by ``torch.segment_reduce`` over the sorted rows, with the
segment lengths from ``bincount``: every sum has a fixed order, so repeat
runs on the card give the same bits (``index_add_``'s float atomics would
not). Empty segments give the reference's values: 0 for sum and mean,
``-inf`` for max. Segment ids must lie in [0, num_segments).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.embedding_bag.ops import embedding_bag_kernel

COMBINES = ("sum", "mean", "max")


def _check_combine(combine: str):
    if combine not in COMBINES:
        raise ValueError(f"unknown combine {combine}")


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  mask: torch.Tensor | None = None, *,
                  combine: str = "sum") -> torch.Tensor:
    """table: (n, d); ids: (B, L); mask: (B, L) bool or weights -> (B, d).
    ``mask=None`` counts every slot."""
    _check_combine(combine)
    if combine == "max":
        return reduce_bag(F.embedding(ids.long(), table), mask, combine="max")
    if mask is None:
        mask = torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
    lead, l = ids.shape[:-1], ids.shape[-1]
    out = embedding_bag_kernel(table, ids.reshape(-1, l),
                               mask.reshape(-1, l)).reshape(*lead, -1)
    if combine == "sum":
        return out
    denom = mask.sum(dim=-1, keepdim=True).to(out.dtype)
    return out / torch.clamp(denom, min=1.0)


def reduce_bag(rows: torch.Tensor, mask: torch.Tensor | None, *,
               combine: str = "sum") -> torch.Tensor:
    """rows: (B, L, d) already gathered (possibly dequantized) embeddings."""
    _check_combine(combine)
    if mask is not None:
        rows = rows * mask[..., None].to(rows.dtype)
    if combine == "sum":
        return rows.sum(dim=-2)
    if combine == "mean":
        if mask is None:
            return rows.sum(dim=-2) / max(rows.shape[-2], 1)
        denom = mask.sum(dim=-1, keepdim=True).to(rows.dtype)
        return rows.sum(dim=-2) / torch.clamp(denom, min=1.0)
    if mask is not None:
        rows = torch.where(mask[..., None].to(torch.bool), rows,
                           torch.finfo(rows.dtype).min)
    return rows.amax(dim=-2)      # ties share the gradient, as in the reference


def _segment_reduce(data, segment_ids, num_segments: int, reduce: str):
    """``reduce`` ("sum" or "max") over the rows of each segment, taken in
    the stable order of ``segment_ids``; returns it with the segment
    lengths."""
    order = torch.argsort(segment_ids, stable=True)
    lengths = torch.bincount(segment_ids.long(), minlength=num_segments)
    out = torch.segment_reduce(data.index_select(0, order), reduce,
                               lengths=lengths, axis=0, unsafe=True)
    return out, lengths


def ragged_embedding_bag(table: torch.Tensor, flat_ids: torch.Tensor,
                         segment_ids: torch.Tensor, num_bags: int, *,
                         combine: str = "sum") -> torch.Tensor:
    """flat_ids (N,), segment_ids (N,) -> (num_bags, d)."""
    _check_combine(combine)
    rows = F.embedding(flat_ids.long(), table)                   # (N, d)
    if combine == "mean":
        return segment_mean(rows, segment_ids, num_bags)
    return _segment_reduce(rows, segment_ids, num_bags, combine)[0]


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """data (N, ...) -> (num_segments, ...), the mean of each segment's rows
    (0 for an empty segment)."""
    s, lengths = _segment_reduce(data, segment_ids, num_segments, "sum")
    c = torch.clamp(lengths.to(s.dtype), min=1.0)
    return s / c.reshape(-1, *([1] * (s.ndim - 1)))
