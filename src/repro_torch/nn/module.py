"""Tree utilities for the dict-based parameter system: the reference's
``repro.nn.module`` over the port's trees (nested dicts and lists of
tensors)."""
from __future__ import annotations

import torch

from repro_torch.train.tree import leaves, tree_map


def param_count(params) -> int:
    """Total number of scalars in a parameter tree."""
    return sum(int(x.numel()) for x in leaves(params))


def param_bytes(params) -> int:
    """Total bytes of a parameter tree at its current dtypes."""
    return sum(int(x.numel()) * x.element_size() for x in leaves(params))


def tree_cast(params, dtype):
    """Every floating leaf cast to ``dtype`` (integer and bool leaves
    untouched)."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    params)


def flatten_with_names(params, prefix: str = ""):
    """Yield (dotted_name, leaf) pairs for a nested-dict tree, keys in
    sorted order; a list is one leaf, as in the reference."""
    if isinstance(params, dict):
        for k in sorted(params):
            yield from flatten_with_names(params[k], f"{prefix}{k}.")
    else:
        yield prefix.rstrip("."), params


def tree_zeros_like(params):
    return tree_map(torch.zeros_like, params)


def global_norm(tree) -> torch.Tensor:
    """L2 norm over all leaves (for gradient clipping and logging), each
    leaf's squares summed in float32."""
    sums = [torch.sum(torch.square(x.to(torch.float32))) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))
