"""Uniform-precision QAT with LSQ+ (the 'LSQ+' row of Table 3).

One bit-width for the whole table (the paper finds b=6 is the lossless
floor). This is MPE with a degenerate one-candidate distribution, which is
the limitation MPE fixes (§1.2), and so it runs through the fused Eq. 9
kernel (``kernels/mpe_qat``) with one width and probability 1: the
mixture ``0 + 1·Q`` is ``lsq_quantize(rows, α, β, b)`` exactly.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantizer
from repro_torch.core.api import BaseCompressor, register
from repro_torch.kernels.mpe_qat.ops import mixed_expectation_kernel
from repro_torch.kernels.segment_sum.ops import gather
from repro_torch.nn import init as initializers


def one_width_quantize(rows: torch.Tensor, alpha: torch.Tensor,
                       beta: torch.Tensor, b: int) -> torch.Tensor:
    """``lsq_quantize(rows, α, β, b)`` for rows (T, d), a scalar α and β
    (d,), through the Eq. 9 kernel at ``bits = (b,)`` with all-ones
    probabilities; differentiable in rows, α and β."""
    ones = torch.ones((rows.shape[0], 1), dtype=rows.dtype, device=rows.device)
    return mixed_expectation_kernel(rows, ones, alpha.reshape(1), beta, (b,))


@register("lsq")
class LSQUniform(BaseCompressor):
    @staticmethod
    def init(gen: torch.Generator, n, d, freqs, cfg):
        del freqs
        cfg = cfg or {}
        std = cfg.get("embed_std", initializers.EMBED_STD)
        b = cfg.get("bits", 6)
        device = gen.device
        return {
            "emb": initializers.normal(gen, (n, d), std=std),
            "alpha": torch.tensor(quantizer.init_alpha(std, b),
                                  dtype=torch.float32, device=device),
            "beta": torch.zeros((d,), dtype=torch.float32, device=device),
        }, {}

    @staticmethod
    def lookup(params, buffers, ids, cfg, *, train=False, step=None):
        del buffers, train, step
        b = (cfg or {}).get("bits", 6)
        rows = gather(params["emb"], ids.reshape(-1).long())
        out = one_width_quantize(rows, params["alpha"], params["beta"], int(b))
        return out.reshape(*ids.shape, out.shape[-1])

    @staticmethod
    def storage_ratio(params, buffers, cfg):
        return (cfg or {}).get("bits", 6) / 32.0
