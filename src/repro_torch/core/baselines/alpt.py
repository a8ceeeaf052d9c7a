"""ALPT — Adaptive Low-Precision Training [arXiv:2212.05735, AAAI'23].

Unlike QAT (full-precision master weights), ALPT keeps the embedding table
in a b-bit representable state *throughout training*: after every optimizer
step the table is projected back onto the quantization grid with stochastic
rounding, with a learnable step size α adapted via LSQ-style gradients. The
paper reports b=8 as ALPT's lossless floor (Table 3) because no
full-precision master copy exists.

The parameter leaf is float but always grid-valued (the dequantized codes);
``post_update`` performs the stochastic-rounding projection, in place (the
Trainer's leaves keep their tensors) and a chunk of rows at a time, with
uniforms drawn from a ``torch.Generator`` on the table's device. The train lookup is the LSQ fake
quantization with β = 0, through the Eq. 9 kernel at one width
(``lsq_uniform.one_width_quantize``); the zero β takes no gradient.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantizer
from repro_torch.core.api import BaseCompressor, register
from repro_torch.core.baselines.lsq_uniform import one_width_quantize
from repro_torch.kernels.segment_sum.ops import gather
from repro_torch.nn import init as initializers

PROJECT_ROWS = 1 << 20


@register("alpt")
class ALPT(BaseCompressor):
    @staticmethod
    def init(gen: torch.Generator, n, d, freqs, cfg):
        del freqs
        cfg = cfg or {}
        std = cfg.get("embed_std", initializers.EMBED_STD)
        b = cfg.get("bits", 8)
        params = {
            "emb": initializers.normal(gen, (n, d), std=std),
            "alpha": torch.tensor(quantizer.init_alpha(std, b),
                                  dtype=torch.float32, device=gen.device),
        }
        ALPT.project_(params["emb"], params["alpha"], b, gen)  # start on-grid
        return params, {}

    @staticmethod
    def project_(emb, alpha, b, gen: torch.Generator, *,
                 row_shard=(0, 1)) -> torch.Tensor:
        """In place, ``PROJECT_ROWS`` rows at a time: each chunk's uniforms
        are drawn from ``gen`` (on the table's device) and it is projected
        by ``_project_``, so the work holds a few copies of a chunk, never
        of the table.

        ``row_shard=(index, count)``: ``emb`` is block ``index`` of
        ``count`` equal row blocks of the table (a ``Trainer`` on a mesh
        holds such a shard). The uniforms are still drawn for the whole
        table, chunk by chunk as one device draws them, and each block
        projects with its own rows' — so the shards together take the
        whole table's projection, bit for bit."""
        index, count = row_shard
        rows_loc = emb.shape[0]
        lo, n_rows = index * rows_loc, count * rows_loc
        for r in range(0, n_rows, PROJECT_ROWS):
            r1 = min(r + PROJECT_ROWS, n_rows)
            u = torch.rand((r1 - r, *emb.shape[1:]), generator=gen,
                           device=emb.device)
            a, z = max(r, lo), min(r1, lo + rows_loc)
            if a < z:
                ALPT._project_(emb[a - lo:z - lo], alpha, b, u[a - r:z - r])
        return emb

    @staticmethod
    def _project_(emb, alpha, b, u) -> torch.Tensor:
        """In place: stochastic rounding of ``emb / α`` onto the signed
        b-bit grid with the uniforms ``u`` (rounded up where u < frac),
        then ``α · codes``, each operation the reference's in float32."""
        n_b, p_b = quantizer.int_bounds(int(b))
        v = emb / alpha
        low = torch.floor(v)
        low.add_(u < v.sub_(low))
        del v
        return torch.mul(alpha, low.clamp_(n_b, p_b), out=emb)

    @staticmethod
    def lookup(params, buffers, ids, cfg, *, train=False, step=None):
        del buffers, step
        b = (cfg or {}).get("bits", 8)
        rows = gather(params["emb"], ids.reshape(-1).long())
        if train:
            # LSQ-style fake quant so α receives its adaptation gradient
            zero = torch.zeros((rows.shape[-1],), dtype=rows.dtype,
                               device=rows.device)
            rows = one_width_quantize(rows, params["alpha"], zero, int(b))
        return rows.reshape(*ids.shape, rows.shape[-1])  # else on the grid

    @staticmethod
    def post_update(params, buffers, cfg, gen, *, row_shard=(0, 1)):
        """The projection after each step; ``row_shard`` as in
        ``project_``."""
        del buffers
        b = (cfg or {}).get("bits", 8)
        ALPT.project_(params["emb"], params["alpha"], int(b), gen,
                      row_shard=row_shard)
        return params

    @staticmethod
    def storage_ratio(params, buffers, cfg):
        return (cfg or {}).get("bits", 8) / 32.0
