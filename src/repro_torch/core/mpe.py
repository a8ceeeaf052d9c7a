"""MPE search-phase embedding layer (paper §3.2–§3.3).

Holds the full-precision table, per-group bit-width logits γ, per-width step
sizes α and per-dimension offsets β. Lookup returns the expectation over
candidate quantizers (Eq. 9) through the fused ``mpe_qat`` kernel (its plain
version on the CPU); ``reg_loss`` is the frequency-weighted expected
bit-width (Eq. 10, second term, without λ).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import quantizer
from repro_torch.kernels.mpe_qat.ops import mixed_expectation_kernel
from repro_torch.kernels.segment_sum.ops import gather
from repro_torch.nn import init as initializers


class MPEConfig(NamedTuple):
    bits: tuple = (0, 1, 2, 3, 4, 5, 6)  # paper §5.1.5
    group_size: int = 128                # paper §5.1.5
    tau: float = 3e-3                    # paper §5.1.5
    lam: float = 1e-5                    # swept in {1e-6 .. 3e-4} (paper)
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


@functools.lru_cache(maxsize=None)
def _bits_vector(bits: tuple, device: torch.device) -> torch.Tensor:
    """The candidate widths as a float32 vector on ``device``, made once: a
    copy from the host in every step would make the host wait for the
    device."""
    return torch.tensor(bits, dtype=torch.float32, device=device)


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
    def lookup(params, buffers, ids: torch.Tensor, cfg: MPEConfig) -> torch.Tensor:
        """ids: int of any shape -> (*ids.shape, d) mixed-precision embeddings."""
        flat = ids.reshape(-1).long()
        # both gathers through ``gather``: its backward sums each row's
        # gradient over its sorted segment of indices in float64, a long
        # segment cut over many workers. A Zipf batch sends half of its
        # lookups to the group of its most frequent features; the
        # library's backward sums each segment's partials in one thread
        rows = gather(params["emb"], flat)                       # (T, d)
        p = MPESearchEmbedding.probabilities(params, cfg)        # (g, m)
        probs = gather(p, buffers["group_of_feature"][flat].long())
        out = mixed_expectation_kernel(rows, probs, params["alpha"],
                                       params["beta"], cfg.bits)
        return out.reshape(*ids.shape, out.shape[-1])

    @staticmethod
    def reg_loss(params, buffers, cfg: MPEConfig) -> torch.Tensor:
        """Eq. (10): Σ_j (1/s_j) Σ_i b_i p_i^j  (caller multiplies by λ)."""
        p = MPESearchEmbedding.probabilities(params, cfg)         # (g, m)
        per_group = p @ _bits_vector(tuple(cfg.bits), p.device)   # (g,)
        return (per_group / buffers["freq_sum"]).sum()

    @staticmethod
    def expected_bits(params, buffers, cfg: MPEConfig) -> torch.Tensor:
        """Average expected bit-width over features (monitoring/compression)."""
        p = MPESearchEmbedding.probabilities(params, cfg)
        per_group = p @ _bits_vector(tuple(cfg.bits), p.device)   # (g,)
        return per_group[buffers["group_of_feature"].long()].mean()
