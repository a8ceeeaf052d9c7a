"""MPE search-phase embedding layer (paper §3.2–§3.3): its parameters, the
frequency-aware groups and the per-group width distribution.

The search lookup (Eq. 9) comes with the training slice and its ``mpe_qat``
kernels; serving needs only ``init``, ``probabilities`` and the sampling of
``repro_torch.core.sampling``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import quantizer
from repro_torch.nn import init as initializers


class MPEConfig(NamedTuple):
    bits: tuple = (0, 1, 2, 3, 4, 5, 6)  # paper §5.1.5
    group_size: int = 128                # paper §5.1.5
    tau: float = 3e-3                    # paper §5.1.5
    embed_std: float = initializers.EMBED_STD


def make_groups(freqs: np.ndarray, group_size: int, device=None):
    """Frequency-aware grouping (§3.2).

    Sort features by frequency (desc, numpy's stable sort so that ties keep
    the reference's order), split into groups of ``group_size``. Returns
    (group_of_feature (n,) int32, freq_sum_per_group (g,) float32).
    """
    freqs = np.asarray(freqs, np.float64)
    n = freqs.shape[0]
    order = np.argsort(-freqs, kind="stable")
    g = -(-n // group_size)
    group_of_rank = np.arange(n) // group_size
    group_of_feature = np.empty((n,), np.int32)
    group_of_feature[order] = group_of_rank.astype(np.int32)
    sums = np.zeros((g,), np.float64)
    np.add.at(sums, group_of_feature, freqs)
    return (torch.from_numpy(group_of_feature).to(device),
            torch.from_numpy(np.maximum(sums, 1.0).astype(np.float32)).to(device))


class MPESearchEmbedding:
    """Functional module. ``buffers`` are non-trained constants."""

    @staticmethod
    def init(gen: torch.Generator, n: int, d: int, freqs, cfg: MPEConfig):
        device = gen.device
        m = len(cfg.bits)
        group_of_feature, freq_sum = make_groups(np.asarray(freqs),
                                                 cfg.group_size, device)
        g = int(freq_sum.shape[0])
        params = {
            "emb": initializers.normal(gen, (n, d), std=cfg.embed_std),
            # all-zero init => uniform distribution over candidate widths (§3.3)
            "gamma": torch.zeros((g, m), dtype=torch.float32, device=device),
            "alpha": torch.tensor([quantizer.init_alpha(cfg.embed_std, b)
                                   for b in cfg.bits],
                                  dtype=torch.float32, device=device),
            "beta": torch.zeros((d,), dtype=torch.float32, device=device),
        }
        buffers = {"group_of_feature": group_of_feature, "freq_sum": freq_sum}
        return params, buffers

    @staticmethod
    def probabilities(params, cfg: MPEConfig) -> torch.Tensor:
        """(g, m) softmax(γ/τ) — Eq. (8)."""
        return torch.softmax(params["gamma"] / cfg.tau, dim=-1)

    @staticmethod
    def expected_bits(params, buffers, cfg: MPEConfig) -> torch.Tensor:
        """Average expected bit-width over features (monitoring/compression)."""
        p = MPESearchEmbedding.probabilities(params, cfg)
        bits = torch.tensor(cfg.bits, dtype=torch.float32, device=p.device)
        per_group = p @ bits                                      # (g,)
        return per_group[buffers["group_of_feature"].long()].mean()
