"""Full-precision backbone embedding (the 'Backbone' row of Table 3)."""
from __future__ import annotations

import torch

from repro_torch.core.api import BaseCompressor, register
from repro_torch.kernels.segment_sum.ops import gather
from repro_torch.nn import init as initializers


@register("plain")
class PlainEmbedding(BaseCompressor):
    @staticmethod
    def init(gen: torch.Generator, n, d, freqs, cfg):
        del freqs
        std = (cfg or {}).get("embed_std", initializers.EMBED_STD)
        return {"emb": initializers.normal(gen, (n, d), std=std)}, {}

    @staticmethod
    def lookup(params, buffers, ids, cfg, *, train=False, step=None):
        del buffers, cfg, train, step
        # through ``gather``: its backward is the port's segment sum
        rows = gather(params["emb"], ids.reshape(-1).long())
        return rows.reshape(*ids.shape, rows.shape[-1])

    @staticmethod
    def storage_ratio(params, buffers, cfg):
        return 1.0
