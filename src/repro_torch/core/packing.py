"""Bit-level packing of sub-8-bit integer codes into 32-bit words (paper §4).

A row of ``d`` codes at ``b`` bits occupies ceil(d*b/32) words; codes are
stored as unsigned offsets ``u = code - N_b`` in [0, 2^b) and may straddle a
word boundary (b ∈ {3,5,6,7}).

PyTorch has no uint32 arithmetic, so a word lives in a ``torch.int32`` tensor
holding the same 32 bits as the reference's uint32 word. The bit work runs in
int64 and is masked to 32 bits: ``>>`` on int32 is arithmetic, not logical.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantizer import int_bounds

_U32 = 0xFFFFFFFF
PACK_ROWS = 1 << 20


def words_per_row(d: int, b: int) -> int:
    return -(-d * b // 32)  # ceil


def row_bytes(d: int, b: int) -> int:
    """Stored bytes of one packed row of ``d`` codes at ``b`` bits."""
    return words_per_row(d, b) * 4


def _bit_layout(d: int, b: int, w: int, device):
    """Per-dimension word index, bit offset, straddle flag, high-part shift
    and second word index — the static layout of one packed row."""
    bitpos = torch.arange(d, device=device, dtype=torch.int64) * b
    w0 = bitpos // 32
    off = bitpos % 32
    straddles = off + b > 32
    shift_hi = torch.clamp(32 - off, 0, 31)
    w1 = torch.clamp(w0 + 1, max=w - 1)
    return w0, off, straddles, shift_hi, w1


def as_int32_words(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 holding the same 32 bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def pack_codes(codes: torch.Tensor, b: int) -> torch.Tensor:
    """codes: (n, d) signed ints in [N_b, P_b] -> (n, W) int32 words. Rows
    are packed ``PACK_ROWS`` at a time: the int64 bit work holds several
    copies of its rows, which for a whole table (41.9 M × 32 codes) would
    be tens of GB."""
    n, d = codes.shape
    n_b, _ = int_bounds(b)
    w = words_per_row(d, b)
    w0, off, straddles, shift_hi, w1 = _bit_layout(d, b, w, codes.device)
    out = torch.empty((n, w), dtype=torch.int32, device=codes.device)
    for r in range(0, n, PACK_ROWS):
        u = codes[r:r + PACK_ROWS].to(torch.int64) - n_b   # in [0, 2^b)
        lo = (u << off) & _U32                              # overflow bits drop
        hi = torch.where(straddles, u >> shift_hi, 0)
        words = torch.zeros((u.shape[0], w), dtype=torch.int64,
                            device=codes.device)
        words.index_add_(1, w0, lo)                   # disjoint bits: add == or
        words.index_add_(1, w1, hi)
        out[r:r + PACK_ROWS] = as_int32_words(words)
    return out


def unpack_codes(words: torch.Tensor, b: int, d: int) -> torch.Tensor:
    """(..., W) int32 words -> (..., d) signed int32 codes."""
    n_b, _ = int_bounds(b)
    w = words.shape[-1]
    w0, off, straddles, shift_hi, w1 = _bit_layout(d, b, w, words.device)
    wu = words.to(torch.int64) & _U32                   # the uint32 value
    lo = wu[..., w0] >> off
    hi = torch.where(straddles, wu[..., w1] << shift_hi, 0)
    u = (lo | hi) & ((1 << b) - 1)
    return u.to(torch.int32) + n_b
