"""OptFS — Optimizing Feature Set via learnable gates [arXiv:2301.10909, WWW'23].

A per-feature gate g ∈ [0,1] multiplies the embedding; learning-by-
continuation sharpens σ(w·τ_anneal) toward a step function over training.
Features with g < 0.5 at the end are dropped (zero rows — the b=0 case of
MPE, §3.1). An L1 regularizer pushes gates closed; the storage ratio is the
kept-row fraction. The gate logits (n,) are gathered as an (n, 1) table, so
their gradient is a width-1 segment sum.
"""
from __future__ import annotations

import torch

from repro_torch.core.api import BaseCompressor, register
from repro_torch.kernels.segment_sum.ops import gather
from repro_torch.nn import init as initializers

ANNEAL_START = 1.0
ANNEAL_END = 100.0


@register("optfs")
class OptFS(BaseCompressor):
    @staticmethod
    def init(gen: torch.Generator, n, d, freqs, cfg):
        del freqs
        std = (cfg or {}).get("embed_std", initializers.EMBED_STD)
        return {
            "emb": initializers.normal(gen, (n, d), std=std),
            # start ~open (σ≈0.73)
            "gate_logit": torch.full((n,), 1.0, dtype=torch.float32,
                                     device=gen.device),
        }, {}

    @staticmethod
    def _anneal(step, total_steps):
        """τ at ``step`` (the Trainer's int32 step tensor), in float32 as the
        reference computes it; ``ANNEAL_END`` where there is no step."""
        if step is None:
            return ANNEAL_END
        if not torch.is_tensor(step):
            step = torch.tensor(step, dtype=torch.int32)
        t = torch.clamp(step / max(total_steps, 1), 0.0, 1.0)
        return ANNEAL_START * (ANNEAL_END / ANNEAL_START) ** t

    @staticmethod
    def lookup(params, buffers, ids, cfg, *, train=False, step=None):
        del buffers
        cfg = cfg or {}
        flat = ids.reshape(-1).long()
        rows = gather(params["emb"], flat)
        logit = gather(params["gate_logit"][:, None], flat)          # (T, 1)
        if train:
            tau = OptFS._anneal(step, cfg.get("total_steps", 1000))
            gate = torch.sigmoid(logit * tau)
        else:
            gate = (logit > 0.0).to(rows.dtype)
        out = rows * gate
        return out.reshape(*ids.shape, out.shape[-1])

    @staticmethod
    def reg_loss(params, buffers, cfg):
        del buffers, cfg
        return torch.mean(torch.sigmoid(params["gate_logit"]))

    @staticmethod
    def storage_ratio(params, buffers, cfg):
        return int((params["gate_logit"] > 0).sum()) / params["gate_logit"].numel()
