"""Plain PyTorch versions of the three flash-attention kernels on their
(B·H, S, hd) layout: the oracle the CUDA kernels are held against, and the
path CPU tensors take.

The forward is the reference's exact softmax (``repro``'s
``kernels/flash_attention/ref.py``): logits ``(q·kᵀ)·hd^-0.5``, masked at
−1e30 above the diagonal when causal, softmax in float32. The backward is
written from the stored logsumexp as the TPU kernel computes it:
``p = exp(s − lse)``, ``dp = do·vᵀ``, ``ds = p·(dp − delta)·scale`` with
``delta = rowsum(do·o)``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _logits(q, k, causal: bool) -> torch.Tensor:
    s, hd = q.shape[1], q.shape[2]
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * hd ** -0.5
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
        logits = torch.where(mask[None], logits, NEG_INF)
    return logits


def flash_attention_ref(q, k, v, causal: bool = True) -> torch.Tensor:
    """q, k, v (BH, S, hd) -> o (BH, S, hd) in q's dtype."""
    p = torch.softmax(_logits(q, k, causal), dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def fwd_stats_ref(q, k, v, causal: bool = True):
    """-> (o (BH, S, hd), lse (BH, S) float32)."""
    logits = _logits(q, k, causal)
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype), lse


def bwd_ref(q, k, v, o, lse, do, causal: bool = True):
    """-> (dq, dk, dv), each (BH, S, hd), from the stored ``lse``."""
    scale = q.shape[2] ** -0.5
    do32 = do.float()
    delta = torch.sum(do32 * o.float(), dim=-1)
    p = torch.exp(_logits(q, k, causal) - lse[..., None])
    dv = torch.einsum("bqk,bqd->bkd", p, do32)
    dp = torch.einsum("bqd,bkd->bqk", do32, v.float())
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float())
    dq = torch.einsum("bqk,bkd->bqd", ds, k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
