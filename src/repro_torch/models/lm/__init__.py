"""The decoder-only LM of every transformer architecture."""
from repro_torch.models.lm.transformer import LM, LMConfig

__all__ = ["LM", "LMConfig"]
