"""Feature-interaction operators for the DLRM backbones (paper §5.1.2).

DNN = MLP only; DCN adds a cross network [arXiv:1708.05123]; DeepFM adds a
factorization machine [Rendle ICDM'10]; IPNN adds an inner-product layer
[arXiv:1611.00144].
"""
from __future__ import annotations

import torch

from repro_torch.nn import init as initializers


def fm_second_order(emb: torch.Tensor) -> torch.Tensor:
    """emb: (B, F, d) -> (B,) FM 2nd-order term: ½Σ_d[(Σ_f v)² − Σ_f v²]."""
    sum_sq = torch.square(emb.sum(dim=1))
    sq_sum = torch.square(emb).sum(dim=1)
    return 0.5 * (sum_sq - sq_sum).sum(dim=-1)


def inner_products(emb: torch.Tensor) -> torch.Tensor:
    """emb: (B, F, d) -> (B, F(F-1)/2) pairwise inner products (IPNN), in
    row-major upper-triangle order."""
    f = emb.shape[1]
    gram = torch.einsum("bfd,bgd->bfg", emb, emb)
    iu, ju = torch.triu_indices(f, f, offset=1, device=emb.device)
    return gram[:, iu, ju]


class CrossNetwork:
    """DCN-v1 cross layers: x_{l+1} = x0 ⊙ (x_l·w_l) + b_l + x_l."""

    @staticmethod
    def init(gen: torch.Generator, dim: int, n_layers: int = 3):
        return {
            "w": [initializers.normal(gen, (dim,), std=0.01)
                  for _ in range(n_layers)],
            "b": [torch.zeros((dim,), device=gen.device)
                  for _ in range(n_layers)],
        }

    @staticmethod
    def apply(params, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for w, b in zip(params["w"], params["b"]):
            x = x0 * (x @ w)[:, None] + b + x
        return x
