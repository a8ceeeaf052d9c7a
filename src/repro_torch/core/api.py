"""Registry of embedding compressors, keyed by method name.

Every compressor is a class of static methods:

    init(gen, n, d, freqs, cfg)          -> (params, buffers)
    lookup(params, buffers, ids, cfg)    -> (*ids, d)
    storage_ratio(params, buffers, cfg)  -> float, stored bytes ratio

This slice registers the serving-time ``packed`` compressor only.
"""
from __future__ import annotations

REGISTRY: dict[str, type] = {}


def register(name: str):
    def deco(cls):
        cls.name = name
        REGISTRY[name] = cls
        return cls
    return deco


def get_compressor(name: str):
    if name not in REGISTRY:
        import repro_torch.core.compressors  # noqa: F401  (registers)
    return REGISTRY[name]
