"""Batch assembly (span gather, padding, the copy to the card) a dispatch,
from the engine's ``RequestStats``: its total over the window's requests
over the window's dispatches."""


def read(layer):
    c = layer["counts"]
    return c["assembly_ms"] / c["dispatches"] if c["dispatches"] else None
