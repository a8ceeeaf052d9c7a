"""Plain PyTorch version of the packed lookup: the oracle the CUDA kernel is
held against, and the path CPU tensors take.

It composes the width buckets exactly as the reference's
``core/inference.py::packed_lookup`` does: gather every bucket's packed row,
unpack, dequantize with one FMA (``addcmul``), then select by the row's width.
"""
from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.core.quantizer import dequantize_codes


def packed_lookup_ref(table, meta, ids: torch.Tensor) -> torch.Tensor:
    """ids: (B,) global feature ids -> (B, d) float32 dequantized rows."""
    bits, d = meta["bits"], meta["d"]
    ids = ids.long()
    widx = table["width_idx"][ids]                              # (B,)
    lidx = table["local_idx"][ids].long()                       # (B,)
    out = torch.zeros((ids.shape[0], d), dtype=torch.float32,
                      device=ids.device)
    for i, b in enumerate(bits):
        if b == 0:
            continue  # zero-width features contribute the zero vector
        sub = table["subtables"][f"b{b}"]
        words = sub[torch.clamp(lidx, 0, sub.shape[0] - 1)]
        codes = packing.unpack_codes(words, b, d)               # (B, d)
        deq = dequantize_codes(codes, table["alpha"][i], table["beta"])
        out = torch.where((widx == i)[:, None], deq, out)
    return out
