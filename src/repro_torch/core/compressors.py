"""Registry adapters exposing the MPE phases and the packed serving table
through the common compressor API."""
from __future__ import annotations

import torch

from repro_torch.core.api import BaseCompressor, register
from repro_torch.core.inference import build_packed_table, packed_lookup
from repro_torch.core.mpe import MPEConfig, MPESearchEmbedding
from repro_torch.core.packing import words_per_row
from repro_torch.core.sampling import (MPERetrainEmbedding, feature_bits,
                                       sample_group_bits)
from repro_torch.core.sampling import storage_ratio as _ratio


def as_mpe_config(cfg) -> MPEConfig:
    """The MPE fields of a compressor config dict (the rest is meta)."""
    if isinstance(cfg, MPEConfig):
        return cfg
    if cfg is None:
        return MPEConfig()
    return MPEConfig(**{k: v for k, v in cfg.items() if k in MPEConfig._fields})


@register("mpe_search")
class MPESearch(BaseCompressor):
    @staticmethod
    def init(gen, n, d, freqs, cfg):
        return MPESearchEmbedding.init(gen, n, d, freqs, as_mpe_config(cfg))

    @staticmethod
    def lookup(params, buffers, ids, cfg, *, train=False, step=None):
        del train, step
        return MPESearchEmbedding.lookup(params, buffers, ids, as_mpe_config(cfg))

    @staticmethod
    def reg_loss(params, buffers, cfg):
        return MPESearchEmbedding.reg_loss(params, buffers, as_mpe_config(cfg))

    @staticmethod
    def storage_ratio(params, buffers, cfg):
        c = as_mpe_config(cfg)
        gb = sample_group_bits(params, c)
        fb = feature_bits(gb, buffers["group_of_feature"])
        return _ratio(fb, c)


@register("mpe_retrain")
class MPERetrain(BaseCompressor):
    """init() expects cfg to carry the search artifacts (see pipeline.py)."""

    @staticmethod
    def init(gen, n, d, freqs, cfg):
        del gen, n, d, freqs
        return MPERetrainEmbedding.init(cfg["init_emb"], cfg["alpha"],
                                        cfg["beta"], cfg["bits_idx"])

    @staticmethod
    def lookup(params, buffers, ids, cfg, *, train=False, step=None):
        del train, step
        return MPERetrainEmbedding.lookup(params, buffers, ids, as_mpe_config(cfg))

    @staticmethod
    def storage_ratio(params, buffers, cfg):
        return _ratio(buffers["bits_idx"], as_mpe_config(cfg))


@register("packed")
class Packed(BaseCompressor):
    """Serving-time compressor: the bit-packed table of §4.

    params = the packed table from ``build_packed_table``; cfg carries the
    static meta {"bits": tuple, "d": int, "n": int}. ``init`` builds a random
    packed table the way the reference's ``Packed.init`` does: the search
    layer's init, γ drawn at random and scaled by 0.01, Eq. 11 sampling and
    the packed export, all on the generator's device.
    """

    @staticmethod
    def draw(gen: torch.Generator, n, d, freqs, cfg):
        """What ``init`` packs: the search layer's init (params, buffers)
        and the Eq. 11 widths (group bits, feature bits) sampled from a γ
        drawn at random and scaled by 0.01 — the full-precision master a
        repack re-quantizes from."""
        c = as_mpe_config(cfg)
        params, buffers = MPESearchEmbedding.init(gen, n, d, freqs, c)
        gamma = 0.01 * torch.randn(params["gamma"].shape, generator=gen,
                                   device=gen.device)
        gb = sample_group_bits({**params, "gamma": gamma}, c)
        fb = feature_bits(gb, buffers["group_of_feature"])
        return params, buffers, gb, fb

    @staticmethod
    def init(gen: torch.Generator, n, d, freqs, cfg):
        params, _, _, fb = Packed.draw(gen, n, d, freqs, cfg)
        table, meta = build_packed_table(params["emb"], fb, params["alpha"],
                                         params["beta"], as_mpe_config(cfg))
        return table, {"meta": meta}

    @staticmethod
    def lookup(params, buffers, ids, cfg, *, train=False, step=None):
        del train, step
        meta = (buffers or {}).get("meta") or {"bits": tuple(cfg["bits"]),
                                               "d": cfg["d"]}
        return packed_lookup(params, meta, ids)

    @staticmethod
    def storage_ratio(params, buffers, cfg):
        """True packed bytes (pad-free) from the width histogram."""
        meta = (buffers or {}).get("meta") or {"bits": tuple(cfg["bits"]),
                                               "d": cfg["d"], "n": cfg["n"]}
        counts = torch.bincount(params["width_idx"].long(),
                                minlength=len(meta["bits"])).tolist()
        n, d = meta["n"], meta["d"]
        packed = sum(counts[i] * words_per_row(d, b) * 4
                     for i, b in enumerate(meta["bits"]) if b > 0)
        return packed / (n * d * 4.0)
