"""QR-Trick — quotient-remainder compositional embeddings [arXiv:1909.02107].

e(id) = E_q[id // k]  ∘  E_r[id % k], with ∘ ∈ {mult, add}. Storage is
(⌈n/k⌉ + k)·d instead of n·d. The MPE paper evaluates it at its minimum 2×
compression (k=2, ratio ≈ 0.5) where it already loses accuracy (Table 3).
Both gathers go through ``gather``; the remainder table's gradient sums the
whole batch into k rows, each a long segment of the segment sum.
"""
from __future__ import annotations

import torch

from repro_torch.core.api import BaseCompressor, register
from repro_torch.kernels.segment_sum.ops import gather
from repro_torch.nn import init as initializers


@register("qr")
class QRTrick(BaseCompressor):
    @staticmethod
    def init(gen: torch.Generator, n, d, freqs, cfg):
        del freqs
        cfg = cfg or {}
        std = cfg.get("embed_std", initializers.EMBED_STD)
        k = cfg.get("k", 2)
        n_q = -(-n // k)
        params = {
            "quot": initializers.normal(gen, (n_q, d), std=std),
            # mult combine: remainder table around 1 so init ≈ quotient table
            "rem": 1.0 + initializers.normal(gen, (k, d), std=std),
        }
        return params, {}

    @staticmethod
    def lookup(params, buffers, ids, cfg, *, train=False, step=None):
        del buffers, train, step
        k = (cfg or {}).get("k", 2)
        combine = (cfg or {}).get("combine", "mult")
        flat = ids.reshape(-1).long()
        q = gather(params["quot"], torch.div(flat, k, rounding_mode="floor"))
        r = gather(params["rem"], torch.remainder(flat, k))
        out = q * r if combine == "mult" else q + r
        return out.reshape(*ids.shape, out.shape[-1])

    @staticmethod
    def storage_ratio(params, buffers, cfg):
        n_q = params["quot"].shape[0]
        k = params["rem"].shape[0]
        # vs. the uncompressed n×d table this replaced
        return float(n_q + k) / float(n_q * (cfg or {}).get("k", 2))
