"""Multi-head attention with GQA, RoPE, optional qk-norm, and a KV cache.

One module serves every model: the LM transformers use GQA + RoPE
(+ qk-norm for qwen3), BST and SASRec small full or causal MHA with learned
positions (``rope_theta=None`` disables RoPE).

Attention over a whole sequence runs through ``kernels/flash_attention``;
attention over a KV cache through ``kernels/decode_attention``, after the
new keys and values are written into the cache in place, both in one
call, by ``kernels/kv_cache_write`` (the CUDA kernels on the card). An extra
``attn_mask`` takes the reference's plain ``gqa_attention``.

Decode: ``kv_cache`` is a dict {"k": (B, S_max, n_kv, hd), "v": ..., "len":
()} holding past keys and values; ``apply`` writes the new token(s) at
position ``len`` — into the cache's own tensors, where the reference
returns new ones — and attends over the valid prefix. The returned cache
holds the same k and v tensors and a new length.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import grouped_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.kv_cache_write.ops import kv_cache_write_kv
from repro_torch.nn.linear import Dense
from repro_torch.nn.norms import RMSNorm
from repro_torch.nn.rope import apply_rope


class MHA:
    @staticmethod
    def init(gen: torch.Generator, d_model: int, n_heads: int,
             n_kv_heads: int | None = None, head_dim: int | None = None, *,
             qk_norm: bool = False, dtype=torch.float32):
        n_kv = n_kv_heads or n_heads
        hd = head_dim or d_model // n_heads
        params = {
            "wq": Dense.init(gen, d_model, n_heads * hd, use_bias=False),
            "wk": Dense.init(gen, d_model, n_kv * hd, use_bias=False),
            "wv": Dense.init(gen, d_model, n_kv * hd, use_bias=False),
            "wo": Dense.init(gen, n_heads * hd, d_model, use_bias=False),
        }
        params = {k: {"kernel": p["kernel"].to(dtype)}
                  for k, p in params.items()}
        if qk_norm:
            params["q_norm"] = RMSNorm.init(hd, dtype, gen.device)
            params["k_norm"] = RMSNorm.init(hd, dtype, gen.device)
        return params

    @staticmethod
    def apply(params, x, *, n_heads: int, n_kv_heads: int, head_dim: int,
              causal: bool = True, rope_theta: float | None = 10000.0,
              positions=None, kv_cache=None, attn_mask=None):
        """x: (B, S, d). Returns (out (B, S, d), new_kv_cache | None)."""
        b, s, _ = x.shape
        hd, n_kv = head_dim, n_kv_heads
        q = Dense.apply(params["wq"], x).reshape(b, s, n_heads, hd)
        k = Dense.apply(params["wk"], x).reshape(b, s, n_kv, hd)
        v = Dense.apply(params["wv"], x).reshape(b, s, n_kv, hd)

        if "q_norm" in params:  # qwen3-style per-head RMS qk-norm
            q = RMSNorm.apply(params["q_norm"], q)
            k = RMSNorm.apply(params["k_norm"], k)

        offset = kv_cache["len"] if kv_cache is not None else 0
        if positions is None and rope_theta is not None:
            positions = (torch.as_tensor(offset, device=x.device)
                         + torch.arange(s, device=x.device)[None, :])
        if rope_theta is not None:
            q = apply_rope(q, positions, rope_theta)
            k = apply_rope(k, positions, rope_theta)

        if kv_cache is None:
            if attn_mask is None:
                out = flash_attention(q, k, v, n_kv_heads=n_kv, causal=causal)
            else:
                out = gqa_attention(q, k, v, n_heads=n_heads, n_kv_heads=n_kv,
                                    causal=causal, attn_mask=attn_mask)
            new_cache = None
        else:
            ck, cv = kv_cache_write_kv(kv_cache["k"], None, k, kv_cache["v"],
                                       None, v, offset)
            new_cache = {"k": ck, "v": cv, "len": offset + s}
            if attn_mask is None:
                out = decode_attention(q, ck, cv, q_offset=offset,
                                       kv_valid_len=offset + s, causal=causal)
            else:
                out = gqa_attention(q, ck, cv, n_heads=n_heads,
                                    n_kv_heads=n_kv, causal=causal,
                                    q_offset=offset, kv_valid_len=offset + s,
                                    attn_mask=attn_mask)
        out = out.reshape(b, s, n_heads * hd)
        return Dense.apply(params["wo"], out), new_cache


def gqa_attention(q, k, v, *, n_heads: int, n_kv_heads: int, causal: bool,
                  q_offset=0, kv_valid_len=None, attn_mask=None):
    """q: (B,S,Hq,hd); k,v: (B,T,Hkv,hd) -> (B,S,Hq,hd): the reference's
    plain grouped-query attention (einsum logits in float32, fp32 softmax,
    probabilities cast to v's dtype). ``q_offset`` / ``kv_valid_len`` may
    be scalars or per-row ``(B,)`` vectors."""
    if q.shape[2] != n_heads or k.shape[2] != n_kv_heads:
        raise ValueError(f"q has {q.shape[2]} heads and k {k.shape[2]}, "
                         f"expected {n_heads} and {n_kv_heads}")
    return grouped_attention(q, k, v, causal=causal, q_offset=q_offset,
                             kv_valid_len=kv_valid_len, attn_mask=attn_mask)


def make_kv_cache(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
                  dtype=torch.bfloat16, prefill_len: int = 0, device=None):
    shape = (batch, max_len, n_kv_heads, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": torch.tensor(prefill_len, dtype=torch.int32, device=device),
    }
