"""Field bookkeeping for multi-field categorical inputs.

One global embedding table spans all feature fields; a sample's per-field
local ids are globalized by adding the field's vocabulary offset.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np


class FieldSpec(NamedTuple):
    name: str
    vocab: int


def field_offsets(fields: Sequence[FieldSpec]) -> np.ndarray:
    sizes = np.asarray([f.vocab for f in fields], np.int64)
    return np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)


def total_vocab(fields: Sequence[FieldSpec]) -> int:
    return int(sum(f.vocab for f in fields))
