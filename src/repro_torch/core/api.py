"""Registry of embedding compressors, keyed by method name.

Every compressor is a class of static methods:

    init(gen, n, d, freqs, cfg)          -> (params, buffers)
    lookup(params, buffers, ids, cfg, *, train=False, step=None) -> (*ids, d)
    reg_loss(params, buffers, cfg)       -> scalar (caller scales by its λ)
    storage_ratio(params, buffers, cfg)  -> float, stored bytes ratio
    post_update(params, buffers, cfg, gen) -> params   (optional projection hook)

``buffers`` are non-trained constants (group maps, frequency stats, width
assignments); ``cfg`` is a plain dict or NamedTuple of static
hyperparameters. Registered: ``mpe_search``, ``mpe_retrain``, ``packed``
and the baselines of paper Table 3 (``plain``, ``lsq``, ``alpt``, ``qr``,
``pep``, ``optfs``).
"""
from __future__ import annotations

import torch

REGISTRY: dict[str, type] = {}


def register(name: str):
    def deco(cls):
        cls.name = name
        REGISTRY[name] = cls
        return cls
    return deco


def get_compressor(name: str):
    if name not in REGISTRY:
        import repro_torch.core.baselines  # noqa: F401  (registers)
        import repro_torch.core.compressors  # noqa: F401  (registers)
    return REGISTRY[name]


class BaseCompressor:
    """Default no-op hooks shared by all compressors."""
    name = "base"

    @staticmethod
    def reg_loss(params, buffers, cfg):
        # a CPU scalar: it combines with a loss on any device, and making it
        # costs no kernel
        return torch.zeros(())

    @staticmethod
    def post_update(params, buffers, cfg, gen):
        return params

