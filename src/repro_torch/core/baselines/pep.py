"""PEP — Plug-in Embedding Pruning with learnable thresholds [arXiv:2101.07577].

ẽ = sign(e) ⊙ relu(|e| − σ(s)) with learnable threshold logits s (one per
embedding dimension, PEP's 'dimension-wise' variant). Parameters whose
magnitude falls below the threshold are exactly zero after training; the
storage ratio is the nonzero fraction (the sparse format's index overhead
is the latency benchmark's to report, as in paper §5.5).
"""
from __future__ import annotations

import torch

from repro_torch.core.api import BaseCompressor, register
from repro_torch.kernels.segment_sum.ops import gather
from repro_torch.nn import init as initializers

THRESH_LOGIT_INIT = -15.0  # PEP paper: start with a vanishing threshold


@register("pep")
class PEP(BaseCompressor):
    @staticmethod
    def init(gen: torch.Generator, n, d, freqs, cfg):
        del freqs
        std = (cfg or {}).get("embed_std", initializers.EMBED_STD)
        return {
            "emb": initializers.normal(gen, (n, d), std=std),
            "thresh_logit": torch.full((d,), THRESH_LOGIT_INIT,
                                       dtype=torch.float32, device=gen.device),
        }, {}

    @staticmethod
    def _prune(rows, thresh_logit):
        t = torch.sigmoid(thresh_logit)
        return torch.sign(rows) * torch.relu(torch.abs(rows) - t)

    @staticmethod
    def lookup(params, buffers, ids, cfg, *, train=False, step=None):
        del buffers, cfg, train, step
        rows = gather(params["emb"], ids.reshape(-1).long())
        out = PEP._prune(rows, params["thresh_logit"])
        return out.reshape(*ids.shape, out.shape[-1])

    @staticmethod
    def storage_ratio(params, buffers, cfg):
        t = torch.sigmoid(params["thresh_logit"])
        emb = params["emb"]
        return int((emb.abs() > t).sum()) / emb.numel()
