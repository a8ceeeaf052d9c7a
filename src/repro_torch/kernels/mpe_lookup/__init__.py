"""Packed-table gather, unpack and dequantize (paper §4)."""
