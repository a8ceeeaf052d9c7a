"""Precision sampling (paper Eq. 11).

After the search phase, each group's final bit-width is the *highest*
candidate whose probability exceeds 1/(2m) — not the argmax (§3.4).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.mpe import MPEConfig, MPESearchEmbedding


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
