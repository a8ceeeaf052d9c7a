"""Precision sampling (paper Eq. 11) and the retraining-phase embedding layer.

After the search phase, each group's final bit-width is the *highest*
candidate whose probability exceeds 1/(2m) — not the argmax (§3.4).

The retrain layer quantizes each row at its sampled width with plain LSQ+/STE;
it is the mixture layer with a one-hot p, so it shares the fused kernel.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.mpe import MPEConfig, MPESearchEmbedding
from repro_torch.kernels.mpe_qat.ops import mixed_expectation_kernel
from repro_torch.kernels.segment_sum.ops import gather


def sample_group_bits(params, cfg: MPEConfig) -> torch.Tensor:
    """Eq. (11): per-group sampled width index, shape (g,) int32."""
    p = MPESearchEmbedding.probabilities(params, cfg)        # (g, m)
    m = len(cfg.bits)
    eligible = p > 1.0 / (2 * m)                              # argmax qualifies
    idx = torch.arange(m, dtype=torch.int32, device=p.device)
    # highest eligible index (bits sorted ascending in cfg)
    return torch.where(eligible, idx, -1).amax(dim=-1).to(torch.int32)


def feature_bits(group_bits_idx: torch.Tensor,
                 group_of_feature: torch.Tensor) -> torch.Tensor:
    """Expand per-group width index to per-feature, shape (n,) int32."""
    return group_bits_idx[group_of_feature.long()]


def _feature_widths(bits_idx, cfg: MPEConfig) -> np.ndarray:
    idx = bits_idx.cpu().numpy() if torch.is_tensor(bits_idx) else bits_idx
    return np.asarray(cfg.bits, np.float32)[np.asarray(idx)]


def average_bits(bits_idx, cfg: MPEConfig) -> float:
    return float(_feature_widths(bits_idx, cfg).mean())


def storage_ratio(bits_idx_per_feature, cfg: MPEConfig) -> float:
    """Bits stored / 32-bit full precision (paper's 'Ratio' column)."""
    return float(_feature_widths(bits_idx_per_feature, cfg).mean() / 32.0)


class MPERetrainEmbedding:
    """Fixed-width QAT layer for the retraining phase (§3.4).

    params: emb (reset to the search phase's *initial* values), alpha, beta
    (warm-started from the searched values). buffers: per-feature width index.
    """

    @staticmethod
    def init(init_emb, searched_alpha, searched_beta, bits_idx_per_feature):
        params = {"emb": init_emb, "alpha": searched_alpha, "beta": searched_beta}
        buffers = {"bits_idx": bits_idx_per_feature.to(torch.int32)}
        return params, buffers

    @staticmethod
    def lookup(params, buffers, ids: torch.Tensor, cfg: MPEConfig) -> torch.Tensor:
        flat = ids.reshape(-1).long()
        rows = gather(params["emb"], flat)        # (T, d), as in the search
        widx = buffers["bits_idx"][flat].long()                   # (T,)
        onehot = F.one_hot(widx, len(cfg.bits)).to(rows.dtype)
        out = mixed_expectation_kernel(rows, onehot, params["alpha"],
                                       params["beta"], cfg.bits)
        return out.reshape(*ids.shape, out.shape[-1])

    @staticmethod
    def reg_loss(params, buffers, cfg: MPEConfig) -> torch.Tensor:
        del params, buffers, cfg
        return torch.zeros(())
