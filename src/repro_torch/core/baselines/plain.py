"""Full-precision backbone embedding (the 'Backbone' row of Table 3)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.api import BaseCompressor, register
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
        return F.embedding(ids.long(), params["emb"])

    @staticmethod
    def storage_ratio(params, buffers, cfg):
        return 1.0
