"""Layers: initializers, dense, LayerNorm, BatchNorm, the MLP tower and
multi-head attention."""
