"""Baseline compressors of paper Table 3; the full-precision ``plain`` table
so far."""
from repro_torch.core.baselines.plain import PlainEmbedding

__all__ = ["PlainEmbedding"]
