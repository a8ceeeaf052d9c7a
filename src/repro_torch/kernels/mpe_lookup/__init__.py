"""Packed-table gather, unpack and dequantize (paper §4)."""
from repro_torch.kernels.mpe_lookup.ops import packed_lookup_kernel
from repro_torch.kernels.mpe_lookup.ref import packed_lookup_ref

__all__ = ["packed_lookup_kernel", "packed_lookup_ref"]
