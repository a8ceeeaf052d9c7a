"""Layers: initializers, dense, LayerNorm, BatchNorm, the MLP tower and
multi-head attention."""
from repro_torch.nn import init as initializers
from repro_torch.nn.linear import Dense
from repro_torch.nn.mlp import MLP
from repro_torch.nn.module import (flatten_with_names, param_bytes,
                                   param_count, tree_cast)
from repro_torch.nn.norms import BatchNorm, LayerNorm, RMSNorm

__all__ = [
    "initializers", "Dense", "MLP", "LayerNorm", "RMSNorm", "BatchNorm",
    "param_count", "param_bytes", "tree_cast", "flatten_with_names",
]
