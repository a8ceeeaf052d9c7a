"""Packed mixed-precision inference table (paper §4).

Storage layout: one bit-packed subtable per non-zero candidate width. Rows are
permuted so every subtable is dense; two index vectors map a global feature
id to (width bucket, local row). Codes are packed into 32-bit words held in
int32 tensors (see ``repro_torch.core.packing``). The export runs on the
device that holds the trained table and is byte-identical to the reference.

A lookup gathers the packed words, unpacks them and dequantizes
``α_b · code + β``: on the card that is the hand-written CUDA kernel
(``repro_torch.kernels.mpe_lookup``), on the CPU its plain version. This
module's ``packed_lookup(table, meta, ids)`` is that kernel's wrapper, under
the reference's name.
"""
from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.core.mpe import MPEConfig
from repro_torch.core.quantizer import int_bounds, quantize_codes
from repro_torch.kernels.mpe_lookup.ops import packed_lookup

__all__ = ["build_packed_table", "packed_lookup", "packed_lookup_fn",
           "packed_specs", "packed_storage_bytes"]


def _pad_rows(n: int, multiple: int) -> int:
    return max(multiple, -(-n // multiple) * multiple)


def _auto_pad_multiple(n: int, n_widths: int, cap: int = 512) -> int:
    """Largest power-of-two ≤ ``cap`` whose worst-case total padding
    (``multiple`` rows per non-empty subtable) stays under n/8 rows."""
    m = 8
    while m < cap and m * 2 * n_widths * 8 <= n:
        m *= 2
    return m


def build_packed_table(emb: torch.Tensor, bits_idx_per_feature: torch.Tensor,
                       alpha: torch.Tensor, beta: torch.Tensor,
                       cfg: MPEConfig, row_pad_multiple: int | None = None,
                       row_capacities: dict | None = None):
    """Quantize + pack a trained table on ``emb``'s device.

    Returns a dict ``table`` of tensors plus a static metadata dict.
    ``row_pad_multiple`` defaults to a size-aware power of two (see
    ``_auto_pad_multiple``). ``row_capacities`` (``{"b<width>": rows}``) pins
    each subtable to an exact padded row count; raises ``ValueError`` when a
    width bucket holds more real rows than its pinned capacity.
    """
    device = emb.device
    # the table owns every tensor it holds (a swap writes them in place)
    bits_idx = bits_idx_per_feature.to(device=device, dtype=torch.int32,
                                       copy=True)
    n, d = emb.shape
    if row_pad_multiple is None:
        n_widths = sum(1 for b in cfg.bits if b != 0)
        row_pad_multiple = _auto_pad_multiple(n, n_widths)

    subtables = {}
    local_idx = torch.zeros((n,), dtype=torch.int32, device=device)
    for i, b in enumerate(cfg.bits):
        sel = torch.nonzero(bits_idx == i).flatten()
        local_idx[sel] = torch.arange(sel.shape[0], dtype=torch.int32,
                                      device=device)
        if b == 0:
            continue
        codes = quantize_codes(emb[sel], alpha[i], beta, int(b))
        if row_capacities is not None:
            padded = int(row_capacities[f"b{b}"])
            if codes.shape[0] > padded:
                raise ValueError(
                    f"width bucket b{b} holds {codes.shape[0]} rows, over its "
                    f"pinned capacity {padded} — a capacity-conforming repack "
                    f"must assign within the compiled subtable shapes")
        else:
            padded = _pad_rows(codes.shape[0], row_pad_multiple)
        n_b, _ = int_bounds(b)
        codes_p = torch.full((padded, d), n_b, dtype=torch.int32, device=device)
        codes_p[:codes.shape[0]] = codes
        del codes
        subtables[f"b{b}"] = packing.pack_codes(codes_p, int(b))

    table = {
        "subtables": subtables,
        "local_idx": local_idx,
        "width_idx": bits_idx,
        "alpha": alpha.to(torch.float32, copy=True),
        "beta": beta.to(torch.float32, copy=True),
    }
    meta = {"bits": tuple(cfg.bits), "d": d, "n": n}
    return table, meta


def packed_lookup_fn(meta):
    """``packed_lookup`` with the static metadata bound: ``(table, ids) ->
    embeddings`` — the lookup-only half that the serving engine times for
    the Figure-5 lookup-vs-compute split."""
    return lambda table, ids: packed_lookup(table, meta, ids)


def packed_storage_bytes(table) -> int:
    """Bytes of the packed subtables (index vectors reported separately)."""
    return sum(int(v.numel()) * 4 for v in table["subtables"].values())


def packed_specs(n: int, d: int, cfg: MPEConfig, width_histogram,
                 row_pad_multiple: int = 512) -> dict:
    """Stand-ins for a packed table, meta tensors for the dry run: the
    reference's ``packed_specs``, with int32 words where it holds uint32.

    ``width_histogram``: fraction of rows per candidate width (sums to 1).
    """
    def sds(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    subtables = {}
    for i, b in enumerate(cfg.bits):
        if b == 0:
            continue
        rows = _pad_rows(int(n * width_histogram[i]), row_pad_multiple)
        subtables[f"b{b}"] = sds((rows, packing.words_per_row(d, b)),
                                 torch.int32)
    return {"subtables": subtables,
            "local_idx": sds((n,), torch.int32),
            "width_idx": sds((n,), torch.int32),
            "alpha": sds((len(cfg.bits),), torch.float32),
            "beta": sds((d,), torch.float32)}
