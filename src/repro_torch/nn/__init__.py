"""Layers: initializers, dense, BatchNorm and the MLP tower."""
