"""Plain PyTorch version of the embedding bag and its backward: the oracle
the CUDA kernel is held against, and the path CPU tensors take.

The forward is the reference's ``embedding_bag(..., combine="sum")``: gather
the rows, multiply by the mask cast to the table's dtype, sum over the L
slots. The backward is the reference's ``_bwd`` (``kernels/embedding_bag/
ops.py``): the bag cotangent times the mask, one (d,) contribution per
(bag, slot), summed into a dense (N, d) gradient at the slot's row.

Both form their products in the table's dtype, as the reference does, and
sum them in float64, rounding once. Float32 sums taken in two orders part
by more than the reference's contract (rtol 1e-5, atol 1e-6) once they
cancel: at 50 slots of N(0, 1) rows, and far more at the most popular row
of a Zipf batch, which gathers about 10^5 contributions. Summed in float64,
the kernels and these versions agree nearly to the bit in any order.
"""
from __future__ import annotations

import torch


def embedding_bag_ref(table, ids, mask) -> torch.Tensor:
    """table (N, d); ids, mask (B, L) -> (B, d) masked sum per bag."""
    rows = table[ids.long()]                                   # (B, L, d)
    prods = rows * mask[..., None].to(table.dtype)
    # the bag sums in float64, rounded once (the kernel's)
    return prods.to(torch.float64).sum(dim=-2).to(table.dtype)  # staticcheck: ignore[RL404]


def contributions(g, mask) -> torch.Tensor:
    """The (B·L, d) float64 contributions ``g[b] * mask[b, j]`` of a bag
    cotangent g (B, d), the products formed in g's dtype."""
    prods = g[:, None, :] * mask[..., None].to(g.dtype)
    # the bag backward's float64 sums (the segment sum's)
    return prods.reshape(-1, g.shape[-1]).to(torch.float64)  # staticcheck: ignore[RL404]


def embedding_bag_bwd_ref(g, ids, mask, n_rows: int) -> torch.Tensor:
    """The dense (n_rows, d) table gradient for the bag cotangent g (B, d):
    ``d_table[ids[b, j]] += g[b] * mask[b, j]``."""
    total = torch.zeros((n_rows, g.shape[-1]), dtype=torch.float64,  # staticcheck: ignore[RL404]
                        device=g.device)
    total.index_add_(0, ids.reshape(-1).long(), contributions(g, mask))
    return total.to(g.dtype)
