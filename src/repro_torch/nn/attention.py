"""Multi-head attention, as the reference's ``nn/attention.py`` computes it
for the recommenders (BST, SASRec): bias-free q, k, v and output
projections around attention over the whole sequence, causal or not.

Attention runs through ``kernels/flash_attention`` (the CUDA kernels on the
card). What the LM transformers add — RoPE, qk-norm, a KV cache, an extra
mask, and the reference's ``gqa_attention`` with per-row offsets and valid
lengths — comes with the LM slice (ROADMAP Queue 1 item 5.4); asking for any
of it raises ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.nn.linear import Dense

LM_SLICE = "comes with the LM slice (ROADMAP Queue 1 item 5.4)"


class MHA:
    @staticmethod
    def init(gen: torch.Generator, d_model: int, n_heads: int,
             n_kv_heads: int | None = None, head_dim: int | None = None, *,
             qk_norm: bool = False):
        if qk_norm:
            raise NotImplementedError(f"MHA qk-norm {LM_SLICE}")
        n_kv = n_kv_heads or n_heads
        hd = head_dim or d_model // n_heads
        return {
            "wq": Dense.init(gen, d_model, n_heads * hd, use_bias=False),
            "wk": Dense.init(gen, d_model, n_kv * hd, use_bias=False),
            "wv": Dense.init(gen, d_model, n_kv * hd, use_bias=False),
            "wo": Dense.init(gen, n_heads * hd, d_model, use_bias=False),
        }

    @staticmethod
    def apply(params, x, *, n_heads: int, n_kv_heads: int, head_dim: int,
              causal: bool = True, rope_theta: float | None = 10000.0,
              positions=None, kv_cache=None, attn_mask=None):
        """x: (B, S, d) -> (out (B, S, d), None). The reference's default
        ``rope_theta`` is kept, so a call must pass ``rope_theta=None``."""
        asked = [name for name, value in (
            ("RoPE", rope_theta), ("positions", positions),
            ("a KV cache", kv_cache), ("attn_mask", attn_mask)) if value is not None]
        if "q_norm" in params:
            asked.append("qk-norm")
        if asked:
            raise NotImplementedError(f"MHA with {', '.join(asked)} {LM_SLICE}")
        b, s, _ = x.shape
        q = Dense.apply(params["wq"], x).reshape(b, s, n_heads, head_dim)
        k = Dense.apply(params["wk"], x).reshape(b, s, n_kv_heads, head_dim)
        v = Dense.apply(params["wv"], x).reshape(b, s, n_kv_heads, head_dim)
        out = flash_attention(q, k, v, n_kv_heads=n_kv_heads, causal=causal)
        return Dense.apply(params["wo"], out.reshape(b, s, n_heads * head_dim)), None
