"""MLP tower used by every DLRM backbone (paper §5.1.5: 1024-512-256), with
BatchNorm between layers, ReLU, and an optional projection head to
``d_out``."""
from __future__ import annotations

import torch

from repro_torch.nn.linear import Dense
from repro_torch.nn.norms import BatchNorm


class MLP:
    @staticmethod
    def init(gen: torch.Generator, d_in: int, hidden: tuple, *,
             d_out: int | None = None, use_batchnorm: bool = True):
        dims = [d_in, *hidden]
        params = {"layers": [Dense.init(gen, dims[i], dims[i + 1])
                             for i in range(len(hidden))]}
        if use_batchnorm:
            params["bn"] = [BatchNorm.init(h, gen.device) for h in hidden]
        if d_out is not None:
            params["head"] = Dense.init(gen, dims[-1], d_out)
        return params

    @staticmethod
    def init_state(hidden: tuple, *, use_batchnorm: bool = True, device=None):
        if not use_batchnorm:
            return {}
        return {"bn": [BatchNorm.init_state(h, device) for h in hidden]}

    @staticmethod
    def apply(params, state, x, *, train: bool = False):
        """Returns (y, new_state); in train mode BatchNorm normalizes with
        the batch statistics and the new state holds the moved running
        statistics."""
        new_bn = []
        for i, layer in enumerate(params["layers"]):
            x = Dense.apply(layer, x)
            if "bn" in params:
                x, s = BatchNorm.apply(params["bn"][i], state["bn"][i], x,
                                       train=train)
                new_bn.append(s)
            x = torch.relu(x)
        if "head" in params:
            x = Dense.apply(params["head"], x)
        return x, ({"bn": new_bn} if "bn" in params else {})
