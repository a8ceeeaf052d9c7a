"""Registry adapter exposing the packed serving table through the common
compressor API."""
from __future__ import annotations

import torch

from repro_torch.core.api import register
from repro_torch.core.inference import build_packed_table, packed_lookup
from repro_torch.core.mpe import MPEConfig, MPESearchEmbedding
from repro_torch.core.packing import words_per_row
from repro_torch.core.sampling import feature_bits, sample_group_bits


def as_mpe_config(cfg) -> MPEConfig:
    """The MPE fields of a compressor config dict (the rest is meta)."""
    return MPEConfig(**{k: v for k, v in (cfg or {}).items()
                        if k in MPEConfig._fields})


@register("packed")
class Packed:
    """Serving-time compressor: the bit-packed table of §4.

    params = the packed table from ``build_packed_table``; cfg carries the
    static meta {"bits": tuple, "d": int, "n": int}. ``init`` builds a random
    packed table the way the reference's ``Packed.init`` does: the search
    layer's init, γ drawn at random and scaled by 0.01, Eq. 11 sampling and
    the packed export, all on the generator's device.
    """

    @staticmethod
    def init(gen: torch.Generator, n, d, freqs, cfg):
        c = as_mpe_config(cfg)
        params, buffers = MPESearchEmbedding.init(gen, n, d, freqs, c)
        gamma = 0.01 * torch.randn(params["gamma"].shape, generator=gen,
                                   device=gen.device)
        gb = sample_group_bits({**params, "gamma": gamma}, c)
        fb = feature_bits(gb, buffers["group_of_feature"])
        table, meta = build_packed_table(params["emb"], fb, params["alpha"],
                                         params["beta"], c)
        return table, {"meta": meta}

    @staticmethod
    def lookup(params, buffers, ids, cfg):
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
