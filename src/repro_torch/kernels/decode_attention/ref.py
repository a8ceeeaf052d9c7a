"""Plain PyTorch version of decode attention: the oracle the CUDA kernel of
``csrc/decode_attention.cu`` is held against, and the path CPU tensors take.

It is the reference's ``gqa_attention`` over its cache
(``repro/nn/attention.py:82-123``, as ``repro/models/lm/transformer.py``
calls it): an int8 cache dequantized to q's dtype (``q.to(dtype) *
scale.to(dtype)``), the logits ``q·kᵀ·hd^-0.5`` in float32 (bf16 operands
are exact there), masked at -1e30 where a key lies beyond the causal bound
``q_offset + i`` or the valid length, a float32 softmax, the probabilities
rounded to v's dtype and ``p·v`` summed in float32, cast to q's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantizer import dequantize_symmetric

NEG_INF = -1e30


def attention_mask(b: int, s: int, t: int, q_offset, kv_valid_len,
                   causal: bool, device) -> torch.Tensor | None:
    """The reference's mask (B|1, S, T): key t is seen by query row i where
    ``t <= q_offset + i`` (causal) and ``t < kv_valid_len``; offsets and
    lengths are scalars or per-row (B,)."""
    k_pos = torch.arange(t, device=device)[None, None, :]
    mask = None
    if causal:
        q_pos = (torch.as_tensor(q_offset, device=device).reshape(-1, 1, 1)
                 + torch.arange(s, device=device)[None, :, None])
        mask = k_pos <= q_pos
    if kv_valid_len is not None:
        valid = k_pos < torch.as_tensor(kv_valid_len,
                                        device=device).reshape(-1, 1, 1)
        mask = valid if mask is None else mask & valid
    return mask


def grouped_attention(q, k, v, *, causal: bool, q_offset=0,
                      kv_valid_len=None, attn_mask=None) -> torch.Tensor:
    """q (B, S, Hq, hd); k, v (B, T, Hkv, hd) in float types -> (B, S, Hq,
    hd) in q's dtype: the reference's ``gqa_attention``."""
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, hd).to(torch.float32)
    logits = torch.einsum("bskgh,btkh->bkgst", qg,
                          k.to(torch.float32)) * hd ** -0.5
    mask = attention_mask(b, s, t, q_offset, kv_valid_len, causal, q.device)
    if mask is not None:
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
    if attn_mask is not None:           # (B, S, T) extra mask
        logits = torch.where(attn_mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh",
                       probs.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(b, s, hq, hd).to(q.dtype)


def decode_attention_ref(q, k, v, k_scale, v_scale, q_offset, kv_valid_len,
                         causal: bool = True) -> torch.Tensor:
    """q (B, S, Hq, hd); k, v (B, T, Hkv, hd) int8 with ``k_scale``,
    ``v_scale`` (B, 1, Hkv, 1), or bf16 or float32 with None -> (B, S, Hq,
    hd) in q's dtype."""
    if k.dtype == torch.int8:
        k = dequantize_symmetric(k, k_scale, q.dtype)
        v = dequantize_symmetric(v, v_scale, q.dtype)
    return grouped_attention(q, k, v, causal=causal, q_offset=q_offset,
                             kv_valid_len=kv_valid_len)
