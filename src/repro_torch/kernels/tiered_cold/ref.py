"""Plain PyTorch version of the cold fill: the oracle the CUDA kernel is
held against, and the path CPU tensors take.

It reads the staged buffer bucket by bucket (the layout of
``csrc/tiered_cold.cu``: counts, row indices, packed words), unpacks each
bucket's words, dequantizes with one FMA (``addcmul``, the rounding of the
port's lookup) and copies the rows into ``out`` at their indices.
"""
from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.core.quantizer import dequantize_codes


def cold_fill_ref(out: torch.Tensor, buf: torch.Tensor, bits, d: int,
                  alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """In place: ``out`` (n, d) float32 takes the staged cold rows of
    ``buf`` (int32) at their row indices; every other row keeps its
    values. Returns ``out``."""
    nb = len(bits)
    counts = [int(c) for c in buf[:nb].tolist()]
    k = sum(counts)
    rows = buf[nb:nb + k].long()
    start, word = 0, nb + k
    for i, b in enumerate(bits):
        c = counts[i]
        if c == 0:
            continue
        if b == 0:
            raise ValueError(f"the staged buffer holds {c} entries of the "
                             f"zero width, which stores no row")
        w = packing.words_per_row(d, b)
        words = buf[word:word + c * w].view(c, w)
        deq = dequantize_codes(packing.unpack_codes(words, b, d), alpha[i],
                               beta)
        out.index_copy_(0, rows[start:start + c], deq)
        start += c
        word += c * w
    return out
